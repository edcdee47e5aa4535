"""The block map of the port's MSDA kernels (``ops/msda.py`` ``query_order``,
``resident_levels``, ``grad_levels``, ``msda_plan``): plain Python, so it is
held here on the CPU.  The kernels that read it run on a GPU only
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from monosowa_tpu_torch.ops import msda

SHIPPED = ((48, 160), (24, 80), (12, 40), (6, 20))      # 384 x 1280 input
# Mask2Former's pixel decoder at 384 x 1280: three levels, coarsest first
PIXEL_DECODER = ((12, 40), (24, 80), (48, 160))
RAGGED = ((13, 21), (7, 11), (4, 6), (2, 3))
ONE_ROW = ((7, 9), (1, 5))
CPU = torch.device("cpu")


def _tokens(shapes):
    return sum(h * w for h, w in shapes)


def _level_tile(shapes):
    """(level, tile) of each token, tiles numbered row-major in a level."""
    level, tile = [], []
    for lvl, (h, w) in enumerate(shapes):
        ys, xs = np.divmod(np.arange(h * w), w)
        level.append(np.full(h * w, lvl))
        tile.append((ys // msda.TILE_H) * -(-w // msda.TILE_W)
                    + xs // msda.TILE_W)
    return np.concatenate(level), np.concatenate(tile)


@pytest.mark.parametrize("shapes", [SHIPPED, RAGGED, ONE_ROW, PIXEL_DECODER])
def test_order_is_a_permutation_and_runs_cover_it(shapes):
    q = _tokens(shapes)
    order, runs = msda.query_order(shapes, q)
    assert order.dtype == np.int32 and runs.dtype == np.int32
    assert sorted(order.tolist()) == list(range(q))     # each exactly once
    # the runs follow one another and cover the order, none is empty
    assert runs[0, 0] == 0 and (runs[:, 1] > 0).all()
    np.testing.assert_array_equal(runs[1:, 0], runs[:-1, 0] + runs[:-1, 1])
    assert runs[-1].sum() == q


@pytest.mark.parametrize("shapes", [SHIPPED, RAGGED, ONE_ROW, PIXEL_DECODER])
def test_tiles_are_consecutive_and_no_run_crosses_a_level(shapes):
    q = _tokens(shapes)
    order, runs = msda.query_order(shapes, q)
    level, tile = _level_tile(shapes)
    # walking the order, a (level, tile) pair never comes back once left,
    # and inside a tile the queries go row-major (ascending index)
    pairs = list(zip(level[order].tolist(), tile[order].tolist()))
    changes = [i for i in range(1, q) if pairs[i] != pairs[i - 1]]
    assert len(changes) + 1 == len(set(pairs))
    for a, b in zip([0] + changes, changes + [q]):
        assert (np.diff(order[a:b]) > 0).all()
    for first, count in runs.tolist():
        in_run = level[order[first:first + count]]
        assert (in_run == in_run[0]).all()
        # a run takes at most RUN_TILES tiles
        assert len(set(tile[order[first:first + count]].tolist())) \
            <= msda.RUN_TILES


@pytest.mark.parametrize("q", [1, 50, 550])
def test_other_queries_go_in_index_order(q):
    order, runs = msda.query_order(SHIPPED, q)
    np.testing.assert_array_equal(order, np.arange(q))
    np.testing.assert_array_equal(runs[:, 0],
                                  np.arange(0, q, msda.RUN_QUERIES))
    assert runs[:, 1].sum() == q and runs[:, 1].max() <= msda.RUN_QUERIES
    plan = msda.msda_plan(SHIPPED, q, 4, 32, CPU)
    assert plan.identity and plan.max_run == min(q, msda.RUN_QUERIES)


def test_resident_rule_at_the_shipped_shape():
    # the encoder: the coarsest level (120 rows of 128 bytes) is copied, its
    # dvalue is summed in shared memory too; level 2 (480 rows) would be
    # read 2,048 times by a run of 128 queries, under 12 reads a row
    plan = msda.msda_plan(SHIPPED, _tokens(SHIPPED), 4, 32, CPU)
    assert not plan.identity and plan.max_run == 128
    assert plan.resident == (3,) and plan.resident_mask == 0b1000
    assert plan.resident_bytes == 6 * 20 * 32 * 4 == 15360
    assert plan.grad == (3,) and plan.grad_bytes == 15360
    # the rule itself, at a run long enough to pay for level 2 as well
    assert msda.resident_levels(SHIPPED, 768, 4, 32) == (2, 3)
    assert (12 * 40 + 6 * 20) * 32 * 4 == 76800 <= msda.RESIDENT_BUDGET
    # and level 1 (1,920 rows, 245,760 bytes) never fits
    assert msda.resident_levels(SHIPPED, 10 ** 6, 4, 32) == (2, 3)


@pytest.mark.parametrize("elem", [4, 2])
def test_pixel_decoder_plan(elem):
    """Mask2Former's pixel decoder (B = 1, Q = S = 10,080, 8 heads of 32,
    4 points): its queries are its tokens, so they go tile by tile, runs of
    two 8 x 8 tiles, starting with the coarsest level (level 0 here); no
    level is resident: the coarsest has 480 rows, and a run of 128 queries
    reads 2,048 of its corner rows, under 12 a row copied."""
    q = _tokens(PIXEL_DECODER)
    assert q == 10080
    plan = msda.msda_plan(PIXEL_DECODER, q, 4, 32, CPU, elem)
    assert not plan.identity and plan.max_run == 128
    order = plan.order.numpy()
    assert sorted(order[:480].tolist()) == list(range(480))
    # 2 x 5, 3 x 10 and 6 x 20 tiles, two a run
    assert plan.n_runs == 5 + 15 + 60
    assert plan.resident == () and plan.grad == ()
    assert 12 * 40 * msda.RESIDENT_MIN_READS > 128 * 4 * 4
    assert list(plan.level_hw) == [12, 40, 24, 80, 48, 160]


@pytest.mark.parametrize("q", [50, 550])
def test_the_decoder_stages_nothing(q):
    plan = msda.msda_plan(SHIPPED, q, 4, 32, CPU)
    assert plan.resident == () and plan.resident_bytes == 0
    assert plan.grad == () and plan.resident_mask == plan.grad_mask == 0


def test_nothing_is_resident_where_the_coarsest_level_exceeds_the_budget():
    shapes = ((80, 80), (40, 40))           # 40 x 40 x 128 bytes = 204,800
    plan = msda.msda_plan(shapes, _tokens(shapes), 2, 32, CPU)
    assert 40 * 40 * 32 * 4 > msda.RESIDENT_BUDGET
    assert plan.resident == () and plan.grad == ()
    # a narrower head brings it back under the budget
    assert msda.resident_levels(shapes, 10 ** 6, 2, 8) == (1,)


def test_grad_levels_are_resident_levels_with_hot_rows():
    # adds per row: 380 queries x 4 points x 4 corners over 6, 24, 77 rows
    resident = msda.resident_levels(RAGGED, 273, 4, 32)
    assert resident == (0, 1, 2, 3)
    assert msda.grad_levels(RAGGED, resident, _tokens(RAGGED), 4) == (3,)
    assert msda.grad_levels(RAGGED, (), _tokens(RAGGED), 4) == ()
    plan = msda.msda_plan(RAGGED, _tokens(RAGGED), 4, 32, CPU)
    assert set(plan.grad) <= set(plan.resident)
    assert plan.grad_mask & ~plan.resident_mask == 0


def test_plan_is_cached_and_holds_what_the_kernels_read():
    q = _tokens(RAGGED)
    plan = msda.msda_plan(RAGGED, q, 4, 32, CPU)
    assert msda.msda_plan(RAGGED, q, 4, 32, CPU) is plan
    assert msda.msda_plan(RAGGED, q, 3, 32, CPU) is not plan
    order, runs = msda.query_order(RAGGED, q)
    assert plan.order.dtype == plan.runs.dtype == torch.int32
    np.testing.assert_array_equal(plan.order.numpy(), order)
    np.testing.assert_array_equal(plan.runs.numpy(), runs)
    assert plan.n_runs == len(runs) and plan.max_run == runs[:, 1].max()
    assert list(plan.level_hw) == [v for hw in RAGGED for v in hw]


# bfloat16 value rows: half the bytes a resident row, the grad copy float32
def test_bf16_rows_at_the_shipped_shape():
    q = _tokens(SHIPPED)
    plan = msda.msda_plan(SHIPPED, q, 4, 32, CPU, 2)
    assert plan is not msda.msda_plan(SHIPPED, q, 4, 32, CPU)
    # the reads rule, not the budget, keeps level 2 out at runs of 128
    assert plan.resident == (3,) and plan.grad == (3,)
    assert plan.resident_bytes == 6 * 20 * 32 * 2 == 7680
    assert plan.grad_bytes == 6 * 20 * 32 * 4 == 15360
    for q_dec in (50, 550):
        assert msda.msda_plan(SHIPPED, q_dec, 4, 32, CPU, 2).resident == ()


@pytest.mark.parametrize("shapes,d,f32,bf16", [
    # 40 x 40 rows of 64 bytes: exactly the budget in bf16, twice it in f32
    (((80, 80), (40, 40)), 32, (), (1,)),
    # d = 16 at long runs: level 1 joins levels 2 and 3 in bf16 only
    (SHIPPED, 16, (2, 3), (1, 2, 3)),
    (SHIPPED, 32, (2, 3), (2, 3)),
])
def test_half_size_rows_let_more_levels_fit(shapes, d, f32, bf16):
    assert msda.resident_levels(shapes, 10 ** 6, 4, d) == f32
    assert msda.resident_levels(shapes, 10 ** 6, 4, d, 4) == f32
    assert msda.resident_levels(shapes, 10 ** 6, 4, d, 2) == bf16


@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("shapes,q", [
    (SHIPPED, _tokens(SHIPPED)), (SHIPPED, 50), (SHIPPED, 550),
    (RAGGED, _tokens(RAGGED)), (ONE_ROW, _tokens(ONE_ROW)),
    (((80, 80), (40, 40)), 6400 + 1600),
    (PIXEL_DECODER, _tokens(PIXEL_DECODER))])
def test_shared_memory_a_block_asks_for(shapes, q, elem):
    """The dynamic shared memory the entry points ask for (msda_fwd.cu:
    the resident copy in value's type; msda_bwd.cu: that copy rounded up to
    16 bytes, then the float32 grad levels) stays within what one block of
    an H100 may have (227 KB), and the forward's within half of it, so two
    forward blocks share an SM."""
    plan = msda.msda_plan(shapes, q, 4, 32, CPU, elem)
    fwd = plan.resident_bytes
    bwd = (-(-fwd // 16) * 16 if plan.grad else fwd) + plan.grad_bytes
    assert fwd <= msda.RESIDENT_BUDGET <= 227 * 1024 // 2
    assert bwd <= 227 * 1024
    # the grad levels are float32 whatever value's type
    assert plan.grad_bytes == 32 * 4 * sum(shapes[lvl][0] * shapes[lvl][1]
                                           for lvl in plan.grad)


# the bf16 forward's lanes, split and block size (csrc/msda_fwd_bf16.cu
# reads them from the plan): four lanes of eight channels to a head of 32,
# a query's samples shared by lane groups of one warp where the launch
# leaves the card mostly idle
@pytest.mark.parametrize("d,lanes,f32_lanes", [
    (32, 4, 8), (24, 4, 8), (8, 4, 8), (40, 8, 16), (64, 8, 16),
    (128, 16, 32), (256, 32, 32)])
def test_bf16_lanes_cover_the_head(d, lanes, f32_lanes):
    assert msda.group_lanes(d, msda.BF16_LANE_CHANNELS) == lanes
    assert lanes * msda.BF16_LANE_CHANNELS >= d or lanes == 32
    assert lanes == 4 or (lanes // 2) * msda.BF16_LANE_CHANNELS < d
    # the float32 kernels keep their lanes of four channels, 8 at least
    assert msda.group_lanes(d, 4) == f32_lanes


@pytest.mark.parametrize("q,pairs,split", [
    (50, 16, 8),         # the decoder at serving: 3,200 lanes
    (550, 16, 2),        # in training: 35,200 lanes
    (800, 16, 2),        # DN-DETR: 51,200 lanes
    (10200, 16, 1),      # the encoder fills the card
    (1, 1, 8),
])
def test_bf16_split_by_launch_size(q, pairs, split):
    plan = msda.msda_plan(SHIPPED, q, 4, 32, CPU, 2, pairs)
    assert plan.lanes == 4 and plan.fwd_split == split
    lanes = pairs * q * plan.lanes
    # the largest power of two that keeps the launch within SPLIT_FILL
    assert split * lanes <= msda.SPLIT_FILL * msda.CARD_THREADS or \
        split == 1
    assert split == msda.FWD16_MAX_SPLIT or \
        2 * split * lanes > msda.SPLIT_FILL * msda.CARD_THREADS
    # a query's groups stay in one warp
    assert plan.lanes * plan.fwd_split <= 32


def test_sample_split_rule():
    card = 132 * 2048
    assert msda.sample_split(1, card, 8) == 8
    assert msda.sample_split(1, card, 4) == 4
    assert msda.sample_split(card, card, 8) == 1
    half = int(msda.SPLIT_FILL * card)
    assert msda.sample_split(half // 2, card, 8) == 2
    assert msda.sample_split(half // 2 + 1, card, 8) == 1
    # the card's size decides, where it is known
    assert msda.sample_split(35200, 2 * card, 8) == 4


@pytest.mark.parametrize("q,pairs,threads", [
    (10200, 16, 512),    # runs of 128 queries x 4 lanes
    (50, 16, 512),       # 16 queries x 32 lanes, capped
    (550, 16, 128),      # 16 queries x 8 lanes
    (33, 2, 512),
])
def test_bf16_block_threads(q, pairs, threads):
    plan = msda.msda_plan(SHIPPED, q, 4, 32, CPU, 2, pairs)
    assert plan.fwd_threads == threads
    assert plan.fwd_threads % 32 == 0
    assert plan.fwd_threads <= msda.FWD16_THREADS
    # a block holds at least one query's groups
    assert plan.fwd_threads >= plan.lanes * plan.fwd_split
    assert plan.fwd_threads == min(
        msda.FWD16_THREADS,
        -(-plan.max_run * plan.lanes * plan.fwd_split // 32) * 32)


def test_block_threads_rule():
    assert msda.block_threads(0, 4, 512) == 32
    assert msda.block_threads(5, 4, 512) == 32
    assert msda.block_threads(9, 4, 512) == 64
    assert msda.block_threads(128, 8, 512) == 512
    assert msda.block_threads(128, 8, 1024) == 1024


def test_the_launch_size_changes_only_the_bf16_fields():
    """The pairs (B x M) a launch has decide the bf16 split and nothing of
    the block map the float32 kernels read."""
    a = msda.msda_plan(SHIPPED, 550, 4, 32, CPU, 2, 16)
    b = msda.msda_plan(SHIPPED, 550, 4, 32, CPU, 2, 1)
    assert a is not b and a.fwd_split == 2 and b.fwd_split == 8
    for field in ("n_runs", "max_run", "identity", "resident", "grad",
                  "resident_bytes", "grad_bytes"):
        assert getattr(a, field) == getattr(b, field), field
    np.testing.assert_array_equal(a.order.numpy(), b.order.numpy())


def test_card_threads_off_the_card():
    assert msda.card_threads(CPU) == msda.CARD_THREADS == 132 * 2048


def test_bf16_block_cap_is_the_kernels_launch_bound():
    """FWD16_THREADS caps the plan's blocks at the bf16 forward's launch
    bound, MSDA_FWD16_THREADS in its source; the two numbers are one."""
    import os
    import re

    src = os.path.join(os.path.dirname(msda.__file__), "csrc",
                       "msda_fwd_bf16.cu")
    with open(src) as f:
        bound = re.search(r"^#define MSDA_FWD16_THREADS (\d+)$", f.read(),
                          re.MULTILINE)
    assert bound and int(bound.group(1)) == msda.FWD16_THREADS


def test_bf16_backward_sorts_the_coarse_levels_at_the_encoder():
    """The bf16 backward sums levels 2 and 3 in the block at the shipped
    encoder (their rows get 340 and 1,360 adds a launch, an image and a
    head); never for the float32 kernels, the decoder's index order or a
    head that is not 32 channels."""
    s = _tokens(SHIPPED)
    plan = msda.msda_plan(SHIPPED, s, 4, 32, CPU, 2, 16)
    assert plan.sort == (2, 3) and plan.sort_mask == 0b1100
    assert msda.sort_smem_bytes(SHIPPED, plan.sort, plan.resident,
                                plan.max_run, 4, 32) \
        <= msda.SORT_SMEM_BUDGET
    assert msda.msda_plan(SHIPPED, s, 4, 32, CPU, 4, 16).sort == ()
    for q in (50, 550, 800):
        assert msda.msda_plan(SHIPPED, q, 4, 32, CPU, 2, 16).sort == ()
    assert msda.msda_plan(SHIPPED, s, 4, 24, CPU, 2, 16).sort == ()


@pytest.mark.parametrize("min_adds,budget,want", [
    (256, 113 * 1024, (2, 3)),
    (1, 113 * 1024, (1, 2, 3)),     # level 0 does not fit
    (1, 1 << 30, (0, 1, 2, 3)),
    (1000, 113 * 1024, (3,)),
    (10 ** 9, 113 * 1024, ()),
    (256, 50 * 1024, (3,)),         # the finest sorted level goes first
])
def test_sorted_levels_rule(monkeypatch, min_adds, budget, want):
    monkeypatch.setattr(msda, "SORT_MIN_ADDS", min_adds)
    monkeypatch.setattr(msda, "SORT_SMEM_BUDGET", budget)
    assert msda.sorted_levels(SHIPPED, (3,), _tokens(SHIPPED), 128, 4,
                              32) == want


def test_sort_smem_bytes():
    # bf16 level 3 (6 x 20 rows of 32), the places of levels 2-3's 600 rows,
    # 128 float32 dout rows, and two 6-byte entries a corner of 128 queries
    # x 8 samples
    assert msda.sort_smem_bytes(SHIPPED, (2, 3), (3,), 128, 4, 32) == \
        7680 + 2416 + 128 * 32 * 4 + 2 * 128 * 8 * 4 * 6

