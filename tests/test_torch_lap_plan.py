"""The LAP kernels' designs on the CPU (``monosowa_tpu_torch/ops/csrc/
lap.cu``): the plan that picks each launch's form from the shape, and
mirrors, written here, of what the kernels compute differently from the
plain versions, each held to the plain version (and so to the JAX
solvers) assignment for assignment:

* the order-preserving float key the kernels reduce with ``redux.sync``;
* JV with each object carrying its owner's potential: the warp form takes
  the step's delta as the value itself and flips the path along the
  objects' ways; the cluster form decodes delta from its key and flips
  the path from a list of the augmentation's steps, each with its
  owner's running potential;
* the auction round whose zero-benefit columns share one bid, the best
  and second values from keys, a row's winner by (bid key, lower column),
  and the rounds in which that bid is the only one, run on the rows
  sorted by price.
"""

import ast
import inspect
import re
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke as cs
from monosowa_tpu.ops import lap as jax_lap
from monosowa_tpu_torch.ops import lap

PAD = 1e6         # the matcher's cost of an invalid target column
INF = float("inf")


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

# (Q, M) -> (form, blocks a problem, objects a lane or thread)
@pytest.mark.parametrize("q,mmax,form,cluster,slots", [
    (50, 50, "warp", 1, 2),            # the decoder's match
    (20, 8, "warp", 1, 1),
    (33, 1, "warp", 1, 2),
    (550, 50, "cluster", 1, 4),        # past the warp form's 512 rows
    (512, 50, "warp", 1, 16),          # the warp form's limit
    (513, 50, "cluster", 1, 4),
    (2000, 50, "cluster", 2, 4),
    (10200, 50, "cluster", 16, 4),     # two_stage's encoder match
    (12000, 50, "cluster", 16, 4),
    (17840, 50, "cluster", 16, 8),     # the clusters' limit at M = 50
    (17841, 50, "tall", 1, 0),
    (300, 300, "cluster", 2, 1),
    (400, 400, "cluster", 4, 1),
    (5000, 7, "cluster", 2, 16),
    (8000, 2000, "tall", 1, 0),
])
def test_jv_plan_picks_the_form_by_shape(q, mmax, form, cluster, slots):
    plan = lap.jv_plan(q, mmax)
    assert (plan.form, plan.cluster, plan.slots) == (form, cluster, slots)
    assert plan.smem_bytes <= lap.SMEM_LIMIT
    if form == "warp":
        assert q <= 32 * plan.slots and plan.threads == lap.WARP_THREADS
    if form == "cluster":
        assert -(-q // cluster) <= lap.CLUSTER_THREADS * plan.slots
        # the smallest cluster whose blocks hold their slices
        smaller = [c for c in lap.CLUSTER_SIZES if c < cluster]
        assert all(lap.jv_cluster_smem_bytes(q, mmax, c) > lap.SMEM_LIMIT
                   or -(-q // c) > lap.CLUSTER_THREADS * lap.SLOTS[-1]
                   for c in smaller)


def test_jv_plan_shared_memory_bytes():
    """Each form's bytes, counted by hand from csrc/lap.cu's layouts (the
    entry points refuse any other count)."""
    # warp: 50 rows of 51 words (50 persons, odd stride), p, uo, way
    assert lap.jv_plan(50, 50).smem_bytes == 4 * (50 * 51 + 3 * 50)
    # persons past Q take no part: 50 x 2000 is stored as 50 x 50
    assert lap.jv_plan(50, 2000).smem_bytes == 4 * (50 * 51 + 3 * 50)
    assert lap.jv_plan(33, 1).smem_bytes == 4 * (33 * 1 + 3 * 33)
    # cluster: 2 x 16 x 8 candidates of 16 bytes, 638 objects a block, 50
    # steps of 4 words
    assert lap.jv_plan(10200, 50).smem_bytes == \
        2 * 16 * 8 * 16 + 4 * (638 * 51 + 4 * 50)
    assert lap.jv_plan(17840, 50).smem_bytes <= lap.SMEM_LIMIT
    assert lap.jv_cluster_smem_bytes(17841, 50, 16) > lap.SMEM_LIMIT
    # tall: u, and the state in shared memory where it fits
    small = lap.jv_plan(8000, 2000)
    assert small.state_in_smem and small.smem_bytes == 4 * (2000 + 40000)
    big = lap.jv_plan(17841, 50)
    assert not big.state_in_smem and big.smem_bytes == 4 * 50
    # the auction: bids, the 50 real columns' costs, prices, owners, rows,
    # the zero columns' bitmask and bid, the round's counts
    plan = lap.auction_plan(50, 50)
    assert plan.smem_bytes == 8 * 50 + 4 * (2500 + 100 + 50 + 40)
    assert plan.threads == 1024                 # 51 warps wanted, 32 given
    assert plan.slots == 2                      # rows a lane, zero rounds
    assert (lap.auction_plan(33, 1).threads,
            lap.auction_plan(33, 1).slots) == (64, 2)
    assert (lap.auction_plan(1024, 50).threads,
            lap.auction_plan(1024, 50).slots) == (1024, 32)
    assert lap.auction_plan(1, 1).slots == 1
    assert lap.auction_plan(1024, 50).smem_bytes <= lap.SMEM_LIMIT


@pytest.mark.parametrize("q,mmax,form", [(10200, 50, "warp"),
                                         (600, 50, "warp"),
                                         (20000, 50, "cluster")])
def test_jv_plan_refuses_a_form_that_cannot_take_the_shape(q, mmax, form):
    with pytest.raises(ValueError, match="lap_jv"):
        lap.jv_plan(q, mmax, form)


@pytest.mark.parametrize("q,mmax", [(4, 6), (1025, 50), (300, 300)])
def test_auction_plan_refuses_what_the_kernel_cannot_take(q, mmax):
    with pytest.raises(ValueError):
        lap.auction_plan(q, mmax)


def test_cluster_form_takes_16_bit_indices():
    """The cluster form's candidates carry an object's index and way step
    in 16 bits each: past 65,534 rows it is not planned, whatever the
    shared memory."""
    assert "cluster" in lap.jv_forms(lap.CLUSTER_MAX_Q, 1)
    assert "cluster" not in lap.jv_forms(lap.CLUSTER_MAX_Q + 1, 1)
    assert lap.jv_plan(lap.CLUSTER_MAX_Q + 1, 1).form == "tall"


def test_plan_constants_are_the_kernels():
    """The plan's block sizes and the cluster's row limit are the
    ``#define``s that csrc/lap.cu launches and checks with."""
    src = (Path(lap.__file__).parent / "csrc" / "lap.cu").read_text()
    defines = dict(re.findall(r"#define (LAP_\w+) (\d+)", src))
    assert {k: int(defines[f"LAP_{k}"]) for k in (
        "WARP_THREADS", "CLUSTER_THREADS", "CLUSTER_MAX_Q",
        "TALL_THREADS")} == {
        "WARP_THREADS": lap.WARP_THREADS,
        "CLUSTER_THREADS": lap.CLUSTER_THREADS,
        "CLUSTER_MAX_Q": lap.CLUSTER_MAX_Q,
        "TALL_THREADS": lap.TALL_THREADS}


def test_every_form_takes_the_decoder_shape():
    """The smoke holds every JV form against the plain version on the
    decoder's problems: each can take 50 x 50."""
    assert set(lap.jv_forms(50, 50)) == set(lap.JV_FORMS)
    assert lap.jv_plan(50, 50, "cluster").cluster == 1
    assert set(lap.jv_forms(10200, 50)) == {"cluster", "tall"}


def test_plans_take_the_shape_alone():
    """The launches ask their plans for the cost's shape and nothing
    else: no count and no cost is read on the host, so a match waits for
    nothing (on the card, chip_smoke.check_match_syncs_nothing)."""
    for fn, plan in ((lap._launch_jv, "jv_plan"),
                     (lap._launch_auction, "auction_plan")):
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
        calls = [node for node in ast.walk(tree)
                 if isinstance(node, ast.Call)
                 and getattr(node.func, "id", "") == plan]
        assert calls and all(
            [ast.unparse(a) for a in call.args] == ["q", "mmax"]
            for call in calls), plan
        assert "n, q, mmax = cost.shape" in inspect.getsource(fn)
    for plan in (lap.jv_plan, lap.auction_plan):
        params = inspect.signature(plan).parameters
        assert [params[k].annotation for k in ("q", "mmax")] == ["int",
                                                                 "int"]


# ---------------------------------------------------------------------------
# the float key
# ---------------------------------------------------------------------------

def key(x):
    """uint32 key of float32 values, as csrc/lap.cu lap_key: -0.0 folded
    onto +0.0, negative values' bits inverted, the others' sign bit set."""
    b = np.asarray(x, np.float32).view(np.uint32).copy()
    b[(b << np.uint32(1)) == 0] = 0
    return np.where(b & np.uint32(0x80000000), ~b,
                    b | np.uint32(0x80000000)).astype(np.uint32)


def unkey(k):
    """float32 values of keys (lap_unkey)."""
    k = np.asarray(k, np.uint32)
    return np.where(k & np.uint32(0x80000000), k & np.uint32(0x7fffffff),
                    ~k).astype(np.uint32).view(np.float32)


SPECIAL = np.array([0.0, -0.0, INF, -INF, 1e-45, -1e-45, 1e-40, -1e-40,
                    1.1754942e-38, -1.1754942e-38, 1.17549435e-38,
                    3.4028235e38, -3.4028235e38, 1.0, -1.0], np.float32)
floats32 = st.one_of(st.floats(width=32, allow_nan=False),
                     st.sampled_from([float(v) for v in SPECIAL]))


@settings(max_examples=400, deadline=None)
@given(floats32, floats32)
def test_key_orders_as_the_floats(a, b):
    ka, kb = key([a, b])
    assert (ka < kb) == (np.float32(a) < np.float32(b))
    assert (ka == kb) == (np.float32(a) == np.float32(b))


@settings(max_examples=200, deadline=None)
@given(floats32)
def test_key_decodes_to_the_value(a):
    back = unkey(key([a]))[0]
    assert back == np.float32(a)
    # the bits too, but for the sign of a zero (folded onto +0.0)
    want = np.float32(0.0 if a == 0 else a)
    assert back.view(np.uint32) == want.view(np.uint32)


def test_key_on_the_special_values():
    k = key(SPECIAL)
    order = np.argsort(SPECIAL, kind="stable")
    assert (np.diff(k[order].astype(np.int64)) >= 0).all()
    assert k[0] == k[1] == 0x80000000
    assert k[2] == 0xff800000 and k[3] == 0x007fffff
    assert (k < 0xffffffff).all()         # no value takes "no object"


# ---------------------------------------------------------------------------
# the problems
# ---------------------------------------------------------------------------

def _generator():
    """The smoke's 22 problems of 50 x 50 (chip_smoke.lap_problems, seed
    8): n_valid 0..50 with padding at the matcher's cost, duplicated
    columns and rows, a constant problem, costs rounded, equal pairs."""
    cost, m = cs.lap_problems(np.random.default_rng(8), torch.device("cpu"))
    return cost, m


def _small_cases():
    """Edge shapes: Q = 1, Q = 33 / M = 1, m = 0 and m = Q, ties of -0.0
    and +0.0, a constant problem, a problem of 20 x 8."""
    rng = np.random.default_rng(11)
    out = [(np.array([[2.5]], np.float32), 1),
           (rng.normal(size=(33, 1)).astype(np.float32), 1),
           (rng.normal(size=(33, 1)).astype(np.float32), 0)]
    z = np.where(rng.random((20, 8)) < 0.5, -0.0, 0.0).astype(np.float32)
    z[3, 2] = -1.0
    out += [(z, 8), (np.full((20, 8), 3.0, np.float32), 8),
            (np.round(rng.normal(size=(20, 8)), 0).astype(np.float32), 5),
            (rng.normal(size=(20, 8)).astype(np.float32), 8)]
    sq = rng.normal(size=(12, 12)).astype(np.float32)
    out += [(sq, 12), (np.round(sq, 0).astype(np.float32), 12)]
    return out


def _each(cases):
    for c, m in cases:
        yield torch.from_numpy(c)[None], torch.tensor([m])


# ---------------------------------------------------------------------------
# JV with the owners' potentials in per-object slots
# ---------------------------------------------------------------------------

def _tkey(x):
    """The key of a float32 tensor, as int64 (torch has no uint32 min)."""
    b = x.contiguous().view(torch.int32).to(torch.int64) & 0xffffffff
    b = torch.where((b & 0x7fffffff) == 0, 0, b)
    return torch.where(b >= 0x80000000, b ^ 0xffffffff, b | 0x80000000)


def _tunkey(k):
    b = torch.where(k >= 0x80000000, k & 0x7fffffff, k ^ 0xffffffff)
    return (b - ((b >> 31) << 32)).to(torch.int32).view(torch.float32)


def jv_mirror(cost, m, cluster):
    """One problem (Q, M) as a kernel form solves it: per object minv, v,
    owner p, owner's potential uo, used and way; the root's u[i] a scalar
    from 0; the argmin on keys (the lowest index on ties).  The warp form
    (``cluster`` False): delta the value itself, way the object, the path
    flipped with its potentials at the augmentation's end.  The cluster
    form: delta decoded from the least key, way the step that last lowered
    minv, and a list of the steps (object, way step, owner, and the
    owner's potential, moved by each later step's delta) from which the
    path is flipped with no object's state but its own."""
    q, mmax = cost.shape
    c = cost.t()                                      # persons x objects
    m = max(0, min(int(m), q, mmax))
    v = torch.zeros(q)
    uo = torch.zeros(q)
    p = torch.full((q,), -1, dtype=torch.long)
    for i in range(m):
        ui = torch.tensor(0.0)
        minv = (c[i] - ui) - v
        way = torch.full((q,), -1, dtype=torch.long)
        used = torch.zeros(q, dtype=torch.bool)
        steps = []                        # [object, way step, owner, u]
        while True:
            mv = torch.where(used, torch.tensor(INF), minv)
            keys = _tkey(mv)
            j1 = int(torch.argmin(keys))              # first on ties
            delta = _tunkey(keys[j1]) if cluster else mv[j1]
            pj1, ui2 = int(p[j1]), uo[j1].clone()
            for st in steps:
                st[3] = st[3] + delta
            steps.append([j1, int(way[j1]), pj1, ui2])
            uo = torch.where(used, uo + delta, uo)
            v = torch.where(used, v - delta, v)
            minv = torch.where(used, minv, minv - delta)
            ui = ui + delta
            used[j1] = True
            if pj1 < 0:
                break
            cur = (c[pj1] - ui2) - v
            better = (cur < minv) & ~used
            minv = torch.where(better, cur, minv)
            way = torch.where(better, len(steps) - 1 if cluster else j1, way)
        j = j1
        if cluster:
            w = steps[-1][1]
            while True:
                p[j], uo[j] = (i, ui) if w < 0 else (steps[w][2], steps[w][3])
                if w < 0:
                    break
                j, w = steps[w][0], steps[w][1]
        else:
            while j >= 0:
                jp = int(way[j])
                if jp < 0:
                    p[j], uo[j] = i, ui
                else:
                    p[j], uo[j] = p[jp], uo[jp]
                j = jp
    return p


@pytest.mark.parametrize("cluster", [False, True], ids=["warp", "cluster"])
def test_jv_mirror_equals_plain_on_the_generator(cluster):
    cost, m = _generator()
    want = lap.solve_lap_jv(cost, m)
    got = torch.stack([jv_mirror(cost[k], m[k], cluster)
                       for k in range(len(m))])
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("cluster", [False, True], ids=["warp", "cluster"])
def test_jv_mirror_equals_plain_on_edge_shapes(cluster):
    for cost, m in _each(_small_cases()):
        want = lap.solve_lap_jv(cost, m)[0]
        got = jv_mirror(cost[0], m[0], cluster)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_jv_mirror_on_a_tall_problem():
    """The encoder match's shape cut to 600 rows (the cluster form's
    chain: few steps an augmentation)."""
    rng = np.random.default_rng(3)
    cost = torch.from_numpy(rng.normal(size=(600, 12)).astype(np.float32))
    for m in (12, 7):
        want = lap.solve_lap_jv(cost[None], torch.tensor([m]))[0]
        torch.testing.assert_close(jv_mirror(cost, m, True), want, rtol=0,
                                   atol=0)


# ---------------------------------------------------------------------------
# the auction with the zero-benefit columns' shared bid
# ---------------------------------------------------------------------------

def _top2(vals):
    """Each row's best value, first column at it and largest of the rest,
    from keys (lap_warp_top2): (best, at, second)."""
    keys = _tkey(vals)
    kmax = keys.max(1, keepdim=True).values
    n = vals.shape[1]
    cols = torch.arange(n).expand_as(keys)
    at = torch.where(keys == kmax, cols, n).min(1).values
    rest = keys.scatter(1, at[:, None], -1)
    ks = rest.max(1).values
    # one column: no second value
    second = torch.where(ks < 0, torch.tensor(-INF), _tunkey(ks.clamp(0)))
    return _tunkey(kmax[:, 0]), at, second


def zero_round_on_sorted_rows(keys, rows, new_key):
    """lap_zero_rounds' round on the rows sorted by (price key, row): the
    first row takes ``new_key`` and moves to its place, each element
    comparing itself and its next with the new one."""
    q = len(keys)
    lst = list(zip(keys.tolist(), rows.tolist()))
    new = (int(new_key), lst[0][1])
    out = []
    for n in range(q):
        nxt = lst[n + 1] if n + 1 < q else (2 ** 32 - 1, 2 ** 16)
        if nxt < new:
            out.append(nxt)
        elif n == 0 or lst[n] < new:
            out.append(new)
        else:
            out.append(lst[n])
    return out


@settings(max_examples=300, deadline=None)
@given(st.integers(2, 300), st.integers(0, 2 ** 32 - 1),
       st.sampled_from([0.0, 0.3, 0.9]))
def test_zero_round_on_sorted_rows(q, seed, tie_share):
    """The shipped zero rounds: the first two sorted rows give the round's
    top two of 0 - prices (the first row at the best, the largest of the
    rest), and the round leaves the rows sorted by the new prices (ties,
    signed zeros and a new price equal to others included)."""
    rng = np.random.default_rng(seed)
    prices = np.round(rng.normal(size=q), 1).astype(np.float32)
    prices[rng.random(q) < tie_share] = prices[-1]
    prices[rng.random(q) < 0.05] = -0.0
    rows = np.arange(q)
    order = np.lexsort((rows, key(prices)))
    keys = key(prices)[order]
    vals = np.float32(0) - prices
    at = int(np.argmax(vals))
    assert order[0] == at
    assert np.float32(0) - unkey(keys[:1])[0] == vals[at]
    assert np.float32(0) - unkey(keys[1:2])[0] == np.delete(vals, at).max()
    new_price = rng.choice([prices[rng.integers(q)], np.float32(
        rng.normal())]).astype(np.float32)
    got = zero_round_on_sorted_rows(keys, order, key([new_price])[0])
    prices[at] = new_price
    want = np.lexsort((rows, key(prices)))
    assert [r for _, r in got] == want.tolist()
    assert [k for k, _ in got] == key(prices)[want].tolist()


def warp_top2_by_blocks(vals, k):
    """Lever 3 of tools/csrc/lap_levers.cu (not shipped): the top two of
    ``vals`` (Q <= 32k values) where lane l holds values lk .. lk + k - 1
    and keeps its best (first on ties) and second; the warp's best key,
    the lowest lane at it, the largest of the lanes' (winner: second,
    others: best) keys, the best where two lanes hold it.  (best value,
    its index, second value)."""
    q = len(vals)
    keys = key(np.concatenate([vals, np.full(32 * k - q, -INF,
                                                np.float32)]))
    lane_keys = keys.reshape(32, k)
    best = lane_keys.argmax(1)                        # first on ties
    kb = lane_keys[np.arange(32), best]
    rest = lane_keys.copy()
    rest[np.arange(32), best] = 0                     # below every key
    ks_lane = rest.max(1) if k > 1 else np.zeros(32, np.uint32)
    kmax = kb.max()
    tied = np.flatnonzero(kb == kmax)
    win = tied[0]
    ks = np.where(kb == kmax, ks_lane, kb).max()
    k2 = kmax if len(tied) > 1 else ks
    return unkey([kmax])[0], win * k + best[win], unkey([k2])[0]


@settings(max_examples=300, deadline=None)
@given(st.integers(1, 1024), st.integers(0, 2 ** 32 - 1),
       st.sampled_from([0.0, 0.3, 0.9]))
def test_warp_top2_by_blocks_equals_top2(q, seed, tie_share):
    """Lever 3's warp top two equal the round's: the first index at the
    largest value and the largest of the rest (ties, signed zeros and one
    value included)."""
    rng = np.random.default_rng(seed)
    vals = np.round(rng.normal(size=q), 1).astype(np.float32)
    vals[rng.random(q) < tie_share] = vals[0]
    vals[rng.random(q) < 0.05] = -0.0
    k = lap._slots(q, 32, lap.AUCTION_SLOTS)
    got = warp_top2_by_blocks(vals, k)
    at = int(np.argmax(vals))
    second = np.max(np.delete(vals, at), initial=-INF)
    assert got[1] == at and got[0] == vals[at] and got[2] == second


def _zero_bid(prices, e):
    """The zero columns' bid: its row and value, from the prices alone."""
    bv0, br0, sv0 = _top2((0.0 - prices)[None, :])
    zrow = int(br0[0])
    return zrow, ((prices[zrow] + bv0[0]) - sv0[0]) + e


def auction_mirror(cost, m, eps, phases=lap.AUCTION_PHASES,
                   rounds=lap.AUCTION_ROUNDS):
    """One problem (Q, M) as lap_auction solves it: real columns j < m bid
    with their own top-2 over the rows; the zero columns j >= m share one
    bid from the prices, made by the lowest-indexed unassigned one; a row
    takes its best real bid by (bid key, lower column), a real column
    winning a tie with the zero bid; no bid where the winner is not
    finite.  Running counts of the columns and of the real columns
    without a row: the first ends the phase; where the second is 0 the
    round is the zero bid's alone (lap_zero_rounds), until a real column
    loses its row."""
    q, mmax = cost.shape
    m = max(0, min(int(m), q, mmax))
    if m == 0:
        return torch.full((q,), -1, dtype=torch.long)
    bT = -cost[:, :m].t()                             # real columns x rows
    prices = torch.zeros(q)
    owner = torch.full((q,), -1, dtype=torch.long)
    for ph in range(phases):
        e = eps[ph]
        owner = torch.full((q,), -1, dtype=torch.long)
        assigned = torch.full((m,), -1, dtype=torch.long)
        zfree = torch.arange(q) >= m
        open_, real_open, it = q, m, 0
        while it < rounds and open_ > 0:
            it += 1
            if real_open == 0:
                zrow, zbid = _zero_bid(prices, e)
                if not torch.isfinite(zbid):
                    break                   # no later round changes a thing
                col = int(torch.nonzero(zfree)[0, 0])    # free at its start
                old = int(owner[zrow])
                if old < 0:
                    open_ -= 1
                elif old < m:
                    assigned[old] = -1
                    real_open = 1
                else:
                    zfree[old] = True
                zfree[col] = False
                owner[zrow], prices[zrow] = col, zbid
                continue
            # a row's best real bid: the highest (key, ~column), packed as
            # the kernel's 64-bit atomicMax packs it (columns < 1024)
            packed = torch.full((q,), -1, dtype=torch.long)
            bidders = torch.nonzero(assigned < 0)[:, 0]
            if len(bidders):
                bv, br, sv = _top2(bT[bidders] - prices[None, :])
                bid = ((prices[br] + bv) - sv) + e
                packed = packed.scatter_reduce(
                    0, br, _tkey(bid) * 1024 + (1023 - bidders), "amax")
            has = packed >= 0
            wv = torch.where(has, _tunkey(packed.clamp(0) >> 10),
                             torch.tensor(-INF))
            wc = torch.where(has, 1023 - (packed & 1023), -1)
            if zfree.any():
                zrow, zbid = _zero_bid(prices, e)
                if not (has[zrow] and wv[zrow] >= zbid):
                    wv[zrow] = zbid
                    wc[zrow] = int(torch.nonzero(zfree)[0, 0])
            hb = torch.isfinite(wv)
            rows, win, old = torch.nonzero(hb)[:, 0], wc[hb], owner[hb]
            # displaced and winning columns are distinct
            out_real = old[(old >= 0) & (old < m)]
            assigned[out_real] = -1
            zfree[old[old >= m]] = True
            assigned[win[win < m]] = rows[win < m]
            zfree[win[win >= m]] = False
            owner[hb], prices[hb] = win, wv[hb]
            open_ -= int((old < 0).sum())
            real_open += len(out_real) - int((win < m).sum())
    return torch.where((owner >= 0) & (owner < m), owner, -1)


def _auction_cases():
    """The generator's problems cut to 8 (m = 0, m = Q, a tie-built
    problem, a constant problem among them) and the edge shapes."""
    cost, m = _generator()
    keep = [0, 1, 2, 3, 4, 5, 6, 8]
    return [(cost[k].numpy(), int(m[k])) for k in keep] + _small_cases()


@pytest.mark.parametrize("case", range(len(_auction_cases())))
def test_auction_mirror_equals_plain(case):
    cost, m = _auction_cases()[case]
    c, n = torch.from_numpy(cost)[None], torch.tensor([m])
    want = lap.solve_lap_auction(c, n)[0]
    got = auction_mirror(c[0], m, lap.auction_eps(c)[0])
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("case", [1, 3, 8, 9])
def test_auction_mirror_equals_jax(case):
    """The JAX solver, on the generator's m = Q and 12-column problems, Q
    = 1 and Q = 33 / M = 1 (JAX's epsilons: the mirror takes the port's,
    computed by the same float32 expressions)."""
    cost, m = _auction_cases()[case]
    c = torch.from_numpy(cost)[None]
    want = np.asarray(jax_lap.solve_lap_auction(jnp.asarray(cost),
                                                jnp.int32(m)))
    got = auction_mirror(c[0], m, lap.auction_eps(c)[0])
    np.testing.assert_array_equal(got.numpy(), want)
