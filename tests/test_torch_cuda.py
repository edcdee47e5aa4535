"""The port's CUDA kernels against their plain versions, on a GPU.

Every test here is marked ``cuda`` and skips without a GPU: a CUDA kernel
has no CPU mode.  The file imports no JAX, so it also runs on a machine
without it (``--noconftest`` skips the suite's JAX setup):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from monosowa_tpu_torch.ops import lap, msda, row_fetch, tfl

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(seed, shapes, q, b, m, d, p, dev):
    """loc in [-0.15, 1.15] so out-of-bounds corners are covered."""
    rng = np.random.default_rng(seed)
    s = sum(h * w for h, w in shapes)
    arrs = (rng.normal(size=(b, s, m, d)),
            rng.uniform(-0.15, 1.15, (b, q, m, len(shapes), p, 2)),
            rng.uniform(0, 1, (b, q, m, len(shapes), p)))
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrs]


# D=8 leaves lanes idle, D=32 fills its 8 lanes, D=48 takes 16 lanes; a
# 1-row level and P=3 (12 samples) cover the loop edges; Q != S, so the
# queries go in index order
@pytest.mark.parametrize("shapes,q,m,d,p", [
    (((12, 20), (6, 10), (3, 5), (2, 3)), 130, 4, 8, 4),
    (((48, 160), (24, 80), (12, 40), (6, 20)), 257, 8, 32, 4),
    (((7, 9), (1, 5)), 33, 2, 48, 3),
])
def test_msda_kernel_matches_plain(cuda, shapes, q, m, d, p):
    value, loc, aw = _inputs(0, shapes, q, 2, m, d, p, cuda)
    before = msda.launches
    got = msda.ms_deform_attn(value, shapes, loc, aw)
    want = msda.ms_deform_attn_plain(value, shapes, loc, aw)
    torch.cuda.synchronize()
    assert msda.launches == before + 1
    assert got.shape == (2, q, m * d)
    # float32 sums in another order
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale


def test_msda_kernel_rejects_other_dtypes(cuda):
    shapes = ((4, 4),)
    value, loc, aw = _inputs(1, shapes, 5, 1, 2, 8, 2, cuda)
    before = msda.launches
    with pytest.raises(TypeError):
        msda.ms_deform_attn(value.half(), shapes, loc, aw)
    assert msda.launches == before


def _dout(seed, q, b, m, d, dev):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(b, q, m * d)).astype(
        np.float32)).to(dev)


# the forward's shapes: lanes idle, full lane groups, 16 lanes a query, a
# 1-row level and P=3; float32 sums in another order (dvalue's atomics in
# an order that changes from run to run): 1e-5 of each output's magnitude.
# Small launches give a query's samples to 4 warps, Q=300 to 2, Q=550 to 1
@pytest.mark.parametrize("shapes,q,m,d,p", [
    (((12, 20), (6, 10), (3, 5), (2, 3)), 130, 4, 8, 4),
    (((48, 160), (24, 80), (12, 40), (6, 20)), 550, 8, 32, 4),
    (((48, 160), (24, 80), (12, 40), (6, 20)), 300, 8, 32, 4),
    (((7, 9), (1, 5)), 33, 2, 48, 3),
])
def test_msda_bwd_kernel_matches_plain(cuda, shapes, q, m, d, p):
    value, loc, aw = _inputs(2, shapes, q, 2, m, d, p, cuda)
    dout = _dout(3, q, 2, m, d, cuda)
    before = msda.bwd_launches
    got = msda._launch_bwd(value, shapes, loc, aw, dout)
    dloc, daw = msda.msda_grad_loc_aw_plain(value, shapes, loc, aw, dout)
    want = (msda.msda_grad_value_plain(value.shape, shapes, loc, aw, dout),
            dloc, daw)
    torch.cuda.synchronize()
    assert msda.bwd_launches == before + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


def test_msda_gradient_goes_through_the_kernels(cuda):
    shapes = ((12, 20), (6, 10), (3, 5), (2, 3))
    value, loc, aw = (t.requires_grad_() for t in
                      _inputs(4, shapes, 37, 2, 4, 8, 4, cuda))
    dout = _dout(5, 37, 2, 4, 8, cuda)
    before = (msda.launches, msda.bwd_launches)
    out = msda.ms_deform_attn(value, shapes, loc, aw)
    assert out.grad_fn is not None
    out.backward(dout)
    torch.cuda.synchronize()
    assert (msda.launches, msda.bwd_launches) == (before[0] + 1,
                                                   before[1] + 1)
    dloc, daw = msda.msda_grad_loc_aw_plain(value.detach(), shapes,
                                            loc.detach(), aw.detach(), dout)
    dvalue = msda.msda_grad_value_plain(value.shape, shapes, loc.detach(),
                                        aw.detach(), dout)
    for t, w in ((value, dvalue), (loc, dloc), (aw, daw)):
        assert float((t.grad - w).abs().max()) <= 1e-5 * float(
            w.abs().max())


def test_msda_bwd_kernel_rejects_other_dtypes(cuda):
    shapes = ((4, 4),)
    value, loc, aw = _inputs(6, shapes, 5, 1, 2, 8, 2, cuda)
    dout = _dout(7, 5, 1, 2, 8, cuda)
    before = msda.bwd_launches
    with pytest.raises(TypeError):
        msda._launch_bwd(value.double(), shapes, loc.double(), aw.double(),
                         dout.double())
    with pytest.raises(TypeError):      # float64 runs on the CPU only
        msda.ms_deform_attn(value.double(), shapes, loc.double(),
                            aw.double())
    assert msda.bwd_launches == before


RAGGED = ((13, 21), (7, 11), (4, 6), (2, 3))
SHIPPED = ((48, 160), (24, 80), (12, 40), (6, 20))


def _tokens(shapes):
    return sum(h * w for h, w in shapes)


def _check_fwd_bwd(shapes, value, loc, aw, dout):
    """Both kernels against their plain versions, 1e-5 of each output's
    magnitude (float32 sums in another order; dvalue's atomics in an order
    that changes from run to run); an output whose plain version is all
    zeros must be all zeros."""
    got = (msda.ms_deform_attn(value, shapes, loc, aw),
           *msda._launch_bwd(value, shapes, loc, aw, dout))
    dloc, daw = msda.msda_grad_loc_aw_plain(value, shapes, loc, aw, dout)
    want = (msda.ms_deform_attn_plain(value, shapes, loc, aw),
            msda.msda_grad_value_plain(value.shape, shapes, loc, aw, dout),
            dloc, daw)
    torch.cuda.synchronize()
    for name, g, w in zip(("out", "dvalue", "dloc", "daw"), got, want):
        assert g.shape == w.shape, name
        assert torch.isfinite(g).all(), name
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max()), \
            name
    return got


# the queries are the pyramid's own tokens (walked in tiles, with ragged
# tiles and runs) on a ragged pyramid, at D = 8 (two of eight lanes idle),
# 32 and 48 (16 lanes a query, 12 of them busy); P = 3 (12 samples: a ragged
# chunk of lanes); B = 1 and M = 1; a 1-row level; D = 6 (one float a lane);
# the shipped pyramid, where levels 2 and 3 are resident
@pytest.mark.parametrize("shapes,b,m,d,p", [
    (RAGGED, 2, 4, 8, 4),
    (RAGGED, 2, 4, 32, 4),
    (RAGGED, 2, 2, 48, 3),
    (RAGGED, 1, 1, 32, 3),
    (((7, 9), (1, 5)), 2, 2, 32, 4),
    (RAGGED, 2, 3, 6, 4),
    (SHIPPED, 1, 2, 32, 4),
])
def test_msda_kernels_on_the_pyramids_own_tokens(cuda, shapes, b, m, d, p):
    q = _tokens(shapes)
    value, loc, aw = _inputs(11, shapes, q, b, m, d, p, cuda)
    plan = msda.msda_plan(shapes, q, p, d, value.device)
    assert sorted(plan.order.tolist()) == list(range(q))
    assert plan.resident, "some level is resident at these shapes"
    _check_fwd_bwd(shapes, value, loc, aw, _dout(12, q, b, m, d, cuda))


def test_msda_kernel_at_the_pixel_decoders_shape(cuda):
    """Mask2Former's pixel decoder at 384 x 1280: three levels, coarsest
    first, B = 1, Q = S = 10,080, 8 heads of 32, 4 points, nothing
    resident; samples near each token's reference point (the ring of the
    offsets' init, jittered) and 2% anywhere in [-0.15, 1.15]."""
    shapes = ((12, 40), (24, 80), (48, 160))
    q, m, d, p = _tokens(shapes), 8, 32, 4
    rng = np.random.default_rng(17)
    ref = np.concatenate([np.stack(np.meshgrid(
        (np.arange(w) + 0.5) / w, (np.arange(h) + 0.5) / h), -1).reshape(
        -1, 2) for h, w in shapes])
    norm = np.array([[w, h] for h, w in shapes], np.float64)
    offs = rng.normal(0, 1.5, (1, q, m, len(shapes), p, 2))
    loc = ref[None, :, None, None, None, :] + offs / norm[:, None, :]
    wild = rng.random(loc.shape[:-1]) < 0.02
    loc[wild] = rng.uniform(-0.15, 1.15, (int(wild.sum()), 2))
    logits = rng.normal(size=(1, q, m, len(shapes) * p))
    aw = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).reshape(
        1, q, m, len(shapes), p)
    value, loc, aw = (torch.from_numpy(a.astype(np.float32)).to(cuda)
                      for a in (rng.normal(size=(1, q, m, d)), loc, aw))
    assert msda.msda_plan(shapes, q, p, d, value.device).resident == ()
    before = msda.launches
    got = msda.ms_deform_attn(value, shapes, loc, aw)
    want = msda.ms_deform_attn_plain(value, shapes, loc, aw)
    torch.cuda.synchronize()
    assert msda.launches == before + 1 and got.shape == (1, q, m * d)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_msda_kernels_with_nothing_resident(cuda):
    # the coarsest level alone (40 x 40 rows of 128 bytes) exceeds the budget
    shapes = ((80, 80), (40, 40))
    q = _tokens(shapes)
    value, loc, aw = _inputs(13, shapes, q, 1, 2, 32, 2, cuda)
    assert msda.msda_plan(shapes, q, 2, 32, value.device).resident == ()
    _check_fwd_bwd(shapes, value, loc, aw, _dout(14, q, 1, 2, 32, cuda))


def test_msda_kernels_all_samples_out_of_bounds(cuda):
    q = _tokens(RAGGED)
    value, loc, aw = _inputs(15, RAGGED, q, 2, 2, 32, 4, cuda)
    loc = torch.where(loc < 0.5, loc - 2.0, loc + 2.0)
    got = _check_fwd_bwd(RAGGED, value, loc, aw, _dout(16, q, 2, 2, 32, cuda))
    for g in got:
        assert float(g.abs().max()) == 0.0


def test_msda_kernels_all_samples_on_one_token(cuda):
    # every sample of every query at the centre of one token of each level:
    # all adds of a level land on one row of dvalue
    q = _tokens(RAGGED)
    value, _, aw = _inputs(17, RAGGED, q, 2, 2, 32, 4, cuda)
    centre = torch.tensor([[(1 + 0.5) / w, (1 + 0.5) / h] for h, w in RAGGED],
                          device=cuda)
    loc = centre.view(1, 1, 1, 4, 1, 2).expand(2, q, 2, 4, 4, 2).contiguous()
    got = _check_fwd_bwd(RAGGED, value, loc, aw, _dout(18, q, 2, 2, 32, cuda))
    touched = (got[1].abs().sum((0, 2, 3)) > 0).sum()
    # a centre that rounds off the grid brings in a neighbouring token
    assert len(RAGGED) <= int(touched) <= 4 * len(RAGGED)


def test_msda_kernels_loc_on_the_pixel_grid(cuda):
    # loc * W - 0.5 exactly integer or half-integer: kernel and plain version
    # must pick the same corners (no fused multiply-add in either)
    shapes = ((16, 32), (8, 16), (4, 8), (2, 4))
    q = _tokens(shapes)
    rng = np.random.default_rng(19)
    value, _, aw = _inputs(19, shapes, q, 2, 2, 32, 4, cuda)
    loc = np.zeros((2, q, 2, 4, 4, 2), np.float32)
    for lvl, (h, w) in enumerate(shapes):
        loc[:, :, :, lvl, :, 0] = rng.integers(-1, 2 * w + 2,
                                               (2, q, 2, 4)) / (2 * w)
        loc[:, :, :, lvl, :, 1] = rng.integers(-1, 2 * h + 2,
                                               (2, q, 2, 4)) / (2 * h)
    _check_fwd_bwd(shapes, value, torch.from_numpy(loc).to(cuda), aw,
                   _dout(20, q, 2, 2, 32, cuda))


def test_msda_kernels_take_tensors_off_16_bytes(cuda):
    # a value that starts 4 bytes into its storage: one float a lane
    value, loc, aw = _inputs(21, RAGGED, 40, 2, 2, 32, 4, cuda)
    shifted = torch.empty(value.numel() + 1, device=cuda)[1:].view_as(value)
    shifted.copy_(value)
    assert shifted.data_ptr() % 16 == 4 and shifted.is_contiguous()
    _check_fwd_bwd(RAGGED, shifted, loc, aw, _dout(22, 40, 2, 2, 32, cuda))


# bfloat16 value rows (the form the TPU kernels K1-K4 read): the kernels
# against the plain versions on the same bf16 value.  out, dloc and daw are
# float32 sums of the same products in another order: 1e-5 of each output's
# magnitude.  dvalue is a float32 sum (atomics in an order that changes from
# run to run) rounded once to bf16: within one bf16 step of the plain
# version's, plus 1e-5 of its magnitude for sums that cancel


def _bf16_ulp(x):
    mag = x.float().abs().clamp(min=1e-30)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _check_fwd_bwd_bf16(shapes, value, loc, aw, dout):
    assert value.dtype == torch.bfloat16
    before = (msda.launches_bf16, msda.bwd_launches_bf16,
              msda.launches, msda.bwd_launches)
    got = (msda.ms_deform_attn(value, shapes, loc, aw),
           *msda._launch_bwd(value, shapes, loc, aw, dout))
    dloc, daw = msda.msda_grad_loc_aw_plain(value, shapes, loc, aw, dout)
    want = (msda.ms_deform_attn_plain(value, shapes, loc, aw),
            msda.msda_grad_value_plain(value.shape, shapes, loc, aw, dout,
                                       value.dtype), dloc, daw)
    torch.cuda.synchronize()
    assert (msda.launches_bf16, msda.bwd_launches_bf16, msda.launches,
            msda.bwd_launches) == (before[0] + 1, before[1] + 1, *before[2:])
    for name, g, w in zip(("out", "dvalue", "dloc", "daw"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert g.dtype == (torch.bfloat16 if name == "dvalue"
                           else torch.float32), name
        assert torch.isfinite(g).all(), name
        diff = (g.float() - w.float()).abs()
        bar = 1e-5 * float(w.float().abs().max())
        if name == "dvalue":
            bar = bar + _bf16_ulp(torch.maximum(g.float().abs(),
                                                w.float().abs()))
        assert bool((diff <= bar).all()), name
    return got


# D = 32: the forward's four 16-byte lanes of 8 channels, the backward's
# eight lanes of 4 (as its float32 form); D = 8 one forward lane; D = 48
# six forward lanes of a group of 8; D = 6 one element a lane; the shipped
# encoder's
# own tokens (level 3 resident in bf16, its grad in float32 behind it), the
# decoder's Q = 50 and 550 (nothing resident, index order, 4 / 1 warps a
# query), a ragged pyramid and a 1-row level
@pytest.mark.parametrize("shapes,q,b,m,d,p", [
    (SHIPPED, None, 1, 2, 32, 4),
    (SHIPPED, 50, 2, 8, 32, 4),
    (SHIPPED, 550, 2, 8, 32, 4),
    (RAGGED, None, 2, 4, 32, 4),
    (RAGGED, None, 2, 4, 8, 4),
    (RAGGED, None, 2, 2, 48, 3),
    (RAGGED, None, 2, 3, 6, 4),
    (((7, 9), (1, 5)), 33, 2, 2, 32, 3),
])
def test_msda_bf16_kernels_match_plain(cuda, shapes, q, b, m, d, p):
    q = q or _tokens(shapes)
    value, loc, aw = _inputs(31, shapes, q, b, m, d, p, cuda)
    plan = msda.msda_plan(shapes, q, p, d, value.device, 2)
    assert plan.resident_bytes == 2 * d * sum(
        shapes[lvl][0] * shapes[lvl][1] for lvl in plan.resident)
    _check_fwd_bwd_bf16(shapes, value.to(torch.bfloat16), loc, aw,
                        _dout(32, q, b, m, d, cuda))


def test_msda_bf16_kernels_take_a_view_off_16_bytes(cuda):
    # a bf16 value 2 bytes into its storage: one element a lane, the same
    # numbers
    value, loc, aw = _inputs(33, RAGGED, 40, 2, 2, 32, 4, cuda)
    shifted = torch.empty(value.numel() + 1, device=cuda,
                          dtype=torch.bfloat16)[1:].view_as(value)
    shifted.copy_(value)
    assert shifted.data_ptr() % 16 == 2 and shifted.is_contiguous()
    _check_fwd_bwd_bf16(RAGGED, shifted, loc, aw,
                        _dout(34, 40, 2, 2, 32, cuda))


def test_msda_bf16_gradient_goes_through_the_kernels(cuda):
    shapes = ((12, 20), (6, 10), (3, 5), (2, 3))
    value, loc, aw = _inputs(35, shapes, 37, 2, 4, 32, 4, cuda)
    value = value.to(torch.bfloat16).requires_grad_()
    loc.requires_grad_()
    aw.requires_grad_()
    dout = _dout(36, 37, 2, 4, 32, cuda)
    before = (msda.launches_bf16, msda.bwd_launches_bf16)
    out = msda.ms_deform_attn(value, shapes, loc, aw)
    out.backward(dout)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32
    assert (msda.launches_bf16, msda.bwd_launches_bf16) == (before[0] + 1,
                                                             before[1] + 1)
    assert (value.grad.dtype, loc.grad.dtype, aw.grad.dtype) == (
        torch.bfloat16, torch.float32, torch.float32)


def test_msda_bf16_kernels_refuse_what_they_cannot_take(cuda):
    shapes = ((4, 4),)
    value, loc, aw = _inputs(37, shapes, 5, 1, 2, 8, 2, cuda)
    dout = _dout(38, 5, 1, 2, 8, cuda)
    v16 = value.to(torch.bfloat16)
    before = (msda.launches_bf16, msda.bwd_launches_bf16)
    with pytest.raises(TypeError):          # loc and aw stay float32
        msda.ms_deform_attn(v16, shapes, loc.to(torch.bfloat16), aw)
    with pytest.raises(TypeError):
        msda._launch_fwd(v16, shapes, loc, aw.to(torch.bfloat16))
    with pytest.raises(TypeError):          # dout is float32
        msda._launch_bwd(v16, shapes, loc, aw, dout.to(torch.bfloat16))
    with pytest.raises(TypeError):          # no float16 form
        msda._launch_fwd(value.half(), shapes, loc, aw)
    assert (msda.launches_bf16, msda.bwd_launches_bf16) == before


def _tfl_inputs(seed, b, s, n_valid, p, t, dev):
    """Per car a scan near the origin and posed clouds around it, with
    planted near-coincident points; the scan's tail past ``n_valid[b]`` is
    masked garbage and a few points inside the valid part are masked too."""
    rng = np.random.default_rng(seed)
    scan = rng.normal(scale=1.0, size=(b, s, 3)).astype(np.float32)
    mask = np.zeros((b, s), bool)
    for i, nv in enumerate(n_valid):
        mask[i, :nv] = True
        mask[i, 3:nv:17] = False
        scan[i, nv:] = 77.0
    poses = rng.normal(scale=1.0, size=(b, p, t, 3)).astype(np.float32)
    k = min(t, s) // 2
    poses[:, 0, :k] = scan[:, :k] + rng.normal(scale=0.05, size=(b, k, 3))
    return [torch.from_numpy(a).to(dev) for a in (scan, mask, poses)]


# T below, at and above the 1024 template points one block pass holds, and
# not a multiple of the 256 threads; S with a masked tail; B = 1; an
# all-masked car (n_valid 0)
@pytest.mark.parametrize("b,s,n_valid,p,t", [
    (1, 512, (400,), 4, 100),
    (3, 2048, (2048, 1500, 0), 7, 1000),
    (2, 300, (300, 1), 5, 1024),
    (2, 1000, (999, 64), 3, 1300),
])
def test_tfl_counts_kernel_equals_plain(cuda, b, s, n_valid, p, t):
    scan, mask, poses = _tfl_inputs(8, b, s, n_valid, p, t, cuda)
    before = tfl.launches
    t_frac, s_frac = tfl.binary_both_way_counts(scan, mask, poses, 0.2)
    t_count, s_count = tfl.binary_both_way_counts_plain(scan, mask, poses,
                                                        0.2)
    want_t, want_s = tfl._fractions(t_count, s_count, mask, t)
    torch.cuda.synchronize()
    assert tfl.launches == before + 1
    assert t_frac.shape == s_frac.shape == (b, p)
    # counts of pairs under the same float32 d2: equal, not close
    assert torch.equal(t_frac, want_t) and torch.equal(s_frac, want_s)
    assert float(t_frac[0, 0]) > 0
    for i, nv in enumerate(n_valid):
        if nv == 0:
            assert float(t_frac[i].abs().max()) == 0
            assert float(s_frac[i].abs().max()) == 0
    # the single-car signature
    t1, s1 = tfl.binary_both_way_counts(scan[0], mask[0], poses[0], 0.2)
    assert torch.equal(t1, t_frac[0]) and torch.equal(s1, s_frac[0])


def test_tfl_counts_kernel_rejects_other_dtypes(cuda):
    scan, mask, poses = _tfl_inputs(9, 1, 64, (64,), 2, 50, cuda)
    before = tfl.launches
    with pytest.raises(TypeError):
        tfl.binary_both_way_counts(scan.double(), mask, poses.double(), 0.2)
    with pytest.raises(ValueError):
        tfl.binary_both_way_counts(scan, mask, poses.cpu(), 0.2)
    assert tfl.launches == before


def _tfl_equal_plain(scan, mask, poses, radius=0.2):
    """One launch; fractions equal to the plain version's, bit for bit."""
    before = tfl.launches
    got = tfl.binary_both_way_counts(scan, mask, poses, radius)
    want = tfl._fractions(*tfl.binary_both_way_counts_plain(
        scan, mask, poses, radius), mask, poses.shape[2])
    torch.cuda.synchronize()
    assert tfl.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w), (g - w).abs().max()
    return got


def _tfl_car(seed, b=2, s=1024, p=10, t=1000):
    """Cars as the fit sees them (chip_smoke.py's inputs): a noisy posed
    template with ground points, poses around the truth."""
    import chip_smoke

    rng = np.random.default_rng(seed)
    return chip_smoke.tfl_inputs(rng, b, p, torch.device("cuda"), t=t, s=s)


# The cell list's cases: points on the grid's cell faces and at exactly r;
# every scan point in one cell; NaN and infinite template and scan points
# (a NaN zeroes a count, as in the plain version's minima); a template far
# from its scan; a box that reaches the cell cap; a template beyond the
# magnitude limit (one cell, all pairs); T of 1 and 513 (one past the
# block's 512 threads: the last round holds one point)
@pytest.mark.parametrize("case", ["faces and r", "one cell", "nan and inf",
                                  "far away", "cell cap", "magnitude",
                                  "t=1", "t=513"])
def test_tfl_counts_cell_list_cases(cuda, case):
    t = {"t=1": 1, "t=513": 513}.get(case, 1000)
    scan, mask, poses = (x.cpu().numpy() for x in _tfl_car(11, t=t))
    rng = np.random.default_rng(12)
    plan = tfl.tfl_cell_plan(scan.shape[1], 0.2)
    if case == "faces and r":
        _, lo, inv, _ = tfl.cell_grid(poses, plan)
        c = np.float32(1) / inv[0, 0]
        faces = (lo[0, 0] + rng.integers(1, 6, (300, 3)) * c).astype(
            np.float32)
        scan[0, :300], mask[0, :300] = faces, True
        poses[0, 0, :150] = faces[:150]
        poses[0, 1, :300] = faces
        poses[0, 1, :300, 0] += np.float32(0.2)      # at r along x
        poses[0, 2, :300] = faces
        poses[0, 2, :300, 2] = np.nextafter(poses[0, 2, :300, 2] + np.float32(
            0.2), np.float32(0))                     # a step inside r
    elif case == "one cell":
        scan[1] = poses[1, 0, 5] + rng.uniform(-0.04, 0.04, scan[1].shape)
        mask[1] = True
    elif case == "nan and inf":
        poses[0, 0, ::9] = np.nan
        poses[0, 1, 4, 2] = np.inf
        poses[1, 2, 7] = -np.inf
        scan[1, 3] = np.nan                          # valid: zeroes t_count
        scan[0, 4] = np.inf
        mask[1, 3] = mask[0, 4] = True
    elif case == "far away":
        poses[0, :2] += np.float32(500.0)
        poses[1, 3] = np.float32(1e9)
    elif case == "cell cap":
        poses[0, 0] = rng.uniform(-25, 25, poses.shape[2:])
        scan[0, :400] = poses[0, 0, :400] + rng.normal(scale=0.1,
                                                       size=(400, 3))
    elif case == "magnitude":
        poses[0, 0, :4] = np.float32(1e35) * np.arange(1, 5)[:, None]
        scan[0, :2], mask[0, :2] = poses[0, 0, :2], True
    dev = torch.device("cuda")
    got = _tfl_equal_plain(*(torch.from_numpy(np.ascontiguousarray(x)).to(
        dev) for x in (scan, mask, poses)))
    modes = tfl.cell_grid(poses, plan)[0]
    if case == "cell cap":
        assert 1 / tfl.cell_grid(poses, plan)[2][0, 0] > plan.c_min
    if case == "magnitude":
        assert modes[0, 0] == 2 and float(got[0][0, 0]) > 0
    if case == "nan and inf":
        assert float(got[1][0, 0]) == 0 and float(got[0][1].abs().max()) == 0
    if case not in ("nan and inf", "far away"):
        assert float(got[0].max()) > 0


def test_tfl_counts_at_the_largest_scan_and_past_it(cuda):
    """S at the limit the all-pairs kernel had (16 + 1 bytes a point in
    227 KB): the cell list takes it with fewer cells; one more point
    raises, as before."""
    s = tfl.S_MAX
    scan, mask, poses = _tfl_car(13, b=2, s=s, p=5)
    assert tfl.tfl_cell_plan(s, 0.2).cell_cap < tfl.CELL_CAP
    _tfl_equal_plain(scan, mask, poses)
    pad = torch.zeros(2, 1, 3, device=scan.device)
    before = tfl.launches
    with pytest.raises(ValueError, match="at most"):
        tfl.binary_both_way_counts(
            torch.cat([scan, pad], 1),
            torch.cat([mask, mask[:, :1]], 1), poses, 0.2)
    assert tfl.launches == before


def test_tfl_counts_car_limit(cuda):
    """B up to 65,535 cars (the grid's y dimension); more raises."""
    scan = torch.zeros(65535, 4, 3, device=cuda)
    mask = torch.ones(65535, 4, dtype=torch.bool, device=cuda)
    poses = torch.zeros(65535, 1, 1, 3, device=cuda)
    poses[-1, 0, 0, 0] = 5.0
    before = tfl.launches
    t_frac, s_frac = tfl.binary_both_way_counts(scan, mask, poses, 0.2)
    assert tfl.launches == before + 1
    want = torch.ones(65535, 1, device=cuda)
    want[-1] = 0
    assert torch.equal(t_frac, want) and torch.equal(s_frac, want)
    before = tfl.launches
    with pytest.raises(ValueError, match="65,535"):
        tfl.binary_both_way_counts(torch.cat([scan, scan[:1]]),
                                   torch.cat([mask, mask[:1]]),
                                   torch.cat([poses, poses[:1]]), 0.2)
    assert tfl.launches == before


@pytest.mark.parametrize("path", ["scale 3200", "scale 160", "robust"])
def test_tfl_counts_at_the_size_stages_shapes(cuda, path):
    """K5 at the shapes of the labeller's size stages, against its plain
    version (equal): the scale detector's two passes, B = 1 with P =
    3,200 (4 templates x 8 lengths x 10 x 10 translations, boxes up to
    1.25 x the template) and P = 160, and the robust fit's
    translation-only grid, B = 4 cars with P = 2 x 40 x 40 = 3,200; T =
    1,000, S = 2,048."""
    from monosowa_tpu_torch.sowa import fitting, scale
    from monosowa_tpu_torch.sowa.templates import TemplateBank

    scan, mask, _ = _tfl_car(14, b=4, s=2048, p=5)
    bank = torch.as_tensor(TemplateBank.default().points, device=cuda)
    if path == "robust":
        cfg = fitting.FitConfig()
        thetas = torch.tensor([0.3, 1.2, 2.5, 4.0], device=cuda)
        thetas = torch.stack([thetas, thetas + np.pi], 1)
        _, trans = fitting._pose_grids(cfg)
        trans = torch.as_tensor(trans, device=cuda)
        posed = (fitting._pose_template(bank[0], thetas.repeat_interleave(
            len(trans), dim=1)) + trans.repeat(2, 1)[None, :, None, :])
        assert posed.shape == (4, 3200, 1000, 3)
        _tfl_equal_plain(scan, mask, posed.contiguous())
        return
    seen = []
    inner = tfl.binary_both_way_loss

    def recording(scan_, mask_, templates, radius):
        seen.append(templates)
        return inner(scan_, mask_, templates, radius)

    tfl.binary_both_way_loss = recording
    try:
        scale.optimize_scale(scan[0], mask[0], bank,
                             torch.tensor([0.1, 0.0, 0.2, 0.7],
                                          device=cuda))
    finally:
        tfl.binary_both_way_loss = inner
    posed = seen[0 if path == "scale 3200" else 1]
    assert posed.shape == ((3200, 1000, 3) if path == "scale 3200"
                           else (160, 1000, 3))
    got = _tfl_equal_plain(scan[:1], mask[:1], posed[None].contiguous())
    assert float(got[0].max()) > 0


# the tool's shape with its clustered indices; rows spread over the whole
# bank with negatives and indices past T (most miss their window), a ragged
# last block and D = 64; an f32 bank, whose 512-row chunk would not fit
# in shared memory (256-row chunks for both forms); a bank smaller than one
# chunk and a block of 7 rows
@pytest.mark.parametrize("form", row_fetch.FORMS)
@pytest.mark.parametrize("t,d,n,bq,block,k_win,dtype,spread", [
    (10240, 128, 10240, 256, None, None, torch.bfloat16, False),
    (3000, 64, 1000, 100, 256, 2, torch.bfloat16, True),
    (4096, 128, 5000, 256, 256, 4, torch.float32, True),
    (100, 8, 333, 7, 128, 3, torch.bfloat16, True),
])
def test_row_fetch_kernels_equal_plain(cuda, form, t, d, n, bq, block, k_win,
                                       dtype, spread):
    rng = np.random.default_rng(10)
    nb = -(-n // bq)
    if spread:
        idx = rng.integers(-t // 20, t + t // 20, n)
    else:
        centers = rng.integers(0, t - 600, nb)
        idx = (centers[:, None] + rng.integers(0, 500, (nb, bq))).reshape(
            -1)[:n]
    idx = torch.from_numpy(idx.astype(np.int32)).to(cuda)
    bank = torch.from_numpy(rng.standard_normal((t, d)).astype(
        np.float32)).to(cuda).to(dtype)
    blk, k = row_fetch.window_params(form, block, k_win)
    before = row_fetch.launches
    got = row_fetch.row_fetch(bank, idx, bq, block, k_win, form)
    want = row_fetch.row_fetch_plain(bank, idx, bq, blk, k)
    torch.cuda.synchronize()
    assert row_fetch.launches == before + 1
    assert got.shape == (n, d) and got.dtype == torch.float32
    # a copy and an exact conversion: equal, not close
    assert torch.equal(got, want)
    covered = float(row_fetch.in_window(idx, t, bq, blk, k).float().mean())
    assert covered == 1.0 if not spread else 0.0 < covered < 1.0


# every index out of its window (all past T, or all negative: base is the
# last window), and a group split unevenly over CTAs (bq 100: 7 CTAs, of
# 15 rows and the last of 10)
@pytest.mark.parametrize("form", row_fetch.FORMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("fill", ["past T", "negative", "bq 100"])
def test_row_fetch_kernels_out_of_window_and_uneven_split(cuda, form, dtype,
                                                          fill):
    rng = np.random.default_rng(14)
    t, d, n, bq = 2048, 64, 1111, 256
    idx = {"past T": rng.integers(t, 2 * t, n),
           "negative": -rng.integers(1, 100, n),
           "bq 100": rng.integers(0, t, n)}[fill]
    if fill == "bq 100":
        bq = 100
    idx = torch.from_numpy(idx.astype(np.int32)).to(cuda)
    bank = torch.from_numpy(rng.standard_normal((t, d)).astype(
        np.float32)).to(cuda).to(dtype)
    blk, k = row_fetch.window_params(form, 256, 2)
    before = row_fetch.launches
    got = row_fetch.row_fetch(bank, idx, bq, blk, k, form)
    want = row_fetch.row_fetch_plain(bank, idx, bq, blk, k)
    torch.cuda.synchronize()
    assert row_fetch.launches == before + 1
    assert torch.equal(got, want)
    if fill != "bq 100":
        assert float(got.abs().max()) == 0


def test_row_fetch_kernel_refuses_what_it_cannot_take(cuda):
    bank = torch.zeros(2048, 128, device=cuda, dtype=torch.float32)
    idx = torch.zeros(256, device=cuda, dtype=torch.int32)
    before = row_fetch.launches
    with pytest.raises(ValueError, match="shared memory"):
        row_fetch.row_fetch(bank, idx, form="staged")   # 512 x 128 x 4 bytes
    with pytest.raises(ValueError, match="multiple of 8"):
        row_fetch.row_fetch(bank[:, :12].contiguous(), idx)
    with pytest.raises(TypeError):
        row_fetch.row_fetch(bank.half(), idx)
    with pytest.raises(ValueError):
        row_fetch.row_fetch(bank, idx.cpu())
    assert row_fetch.launches == before


@pytest.mark.parametrize("w", [160, 1242])
def test_extract_frames_banked_on_the_card_matches_the_cpu(cuda, w):
    """Bank-mode extraction on the card against the port on the CPU: the
    same surviving masks, counts and truncation flags, centres within
    2e-3 m, and stage A (the dispatch) waits for nothing on the card."""
    from monosowa_tpu_torch.sowa.candidates import CandidateConfig
    from monosowa_tpu_torch.sowa.candidates_device import DeviceExtractor

    rng = np.random.default_rng(w)
    h, fu = 96, 120.0
    p2 = np.array([[fu, 0, w / 2, 0], [0, fu, h / 2, 0], [0, 0, 1, 0]],
                  np.float32)
    depths, masks = [], []
    for f in range(3):
        d = np.minimum(np.full((h, w), 300.0, np.float32),
                       (fu * 1.6 / np.maximum(np.arange(h)[:, None] - h / 2,
                                              1)).astype(np.float32)
                       * np.ones((h, w), np.float32))
        ms = []
        for (x1, y1, bw, bh, z) in ((40, 20, 30, 14, 12.0),
                                    (0, 40, 40, 22, 7.0 + f),
                                    (w - 20, 30, 20, 10, 200.0)):
            m = np.zeros((h, w), bool)
            m[y1:y1 + bh, x1:x1 + bw] = True
            d[m] = z + rng.normal(scale=0.01, size=int(m.sum()))
            ms.append(m)
        depths.append(d)
        masks.append(ms)
    cfg = CandidateConfig(moving_detection_threshold=2, filter_diameter=4.0)
    got_ext = DeviceExtractor(p2, (h, w), cfg, frame_bucket=2, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = got_ext.extract_frames_banked_begin(depths, masks, cap=512)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got, bank_got = got_ext.extract_frames_banked_finish(state)
    want, bank_want = DeviceExtractor(p2, (h, w), cfg, frame_bucket=2,
                                      device="cpu").extract_frames_banked(
        depths, masks, cap=512)
    assert bank_got.is_cuda and bank_got.shape == bank_want.shape
    for a, b in zip(got, want):
        assert a["points"] == b["points"] and len(b["points"]) == 2
        np.testing.assert_allclose(a["locations"], b["locations"], atol=2e-3)
        for ref in a["points"]:
            np.testing.assert_allclose(
                bank_got[ref.row, ref.mi, :ref.count].cpu().numpy(),
                bank_want[ref.row, ref.mi, :ref.count].numpy(), atol=1e-4)


def _lap_problems(seed, n, q, mmax):
    """n problems of q x mmax: random scales, n_valid in 0..mmax with the
    columns past it at the matcher's padding cost, and ties (duplicated
    columns and rows, constant problems)."""
    rng = np.random.default_rng(seed)
    cost = (rng.normal(size=(n, q, mmax))
            * 10 ** rng.uniform(-2, 2, (n, 1, 1))).astype(np.float32)
    m = rng.integers(0, mmax + 1, n)
    m[:2] = (0, mmax)
    if n > 3 and mmax > 5:
        cost[2, :, 5] = cost[2, :, 1]
        cost[2, 9] = cost[2, 4]
        cost[3] = 1.0
    for k in range(n):
        cost[k, :, m[k]:] = 1e6
    return torch.from_numpy(cost), torch.from_numpy(m)


@pytest.mark.parametrize("n,q,mmax", [(22, 50, 50), (7, 20, 8), (3, 33, 1),
                                      (4, 100, 90)])
def test_lap_jv_kernel_equals_plain(cuda, n, q, mmax):
    cost, m = _lap_problems(n, n, q, mmax)
    before = lap.jv_launches
    got = lap.lap_jv(cost.to(cuda), m.to(cuda))
    torch.cuda.synchronize()
    assert lap.jv_launches == before + 1
    assert got.dtype == torch.int64 and got.shape == (n, q)
    torch.testing.assert_close(got.cpu(), lap.solve_lap_jv(cost, m),
                               rtol=0, atol=0)


@pytest.mark.parametrize("n,q,mmax", [(4, 2000, 50), (2, 10200, 50),
                                      (2, 12000, 50), (3, 5000, 7),
                                      (2, 300, 300)])
def test_lap_jv_tall_form_equals_plain(cuda, n, q, mmax):
    """Problems too tall for the one-warp form's shared memory take
    ``lap_jv_tall``: the two-stage encoder match (10,200 x 50), its state
    in shared memory; past about 11,600 rows in device memory."""
    cost, m = _lap_problems(n + 200, n, q, mmax)
    assert lap.jv_smem_bytes(q, mmax) > lap.SMEM_LIMIT
    before, tall = lap.jv_launches, lap.jv_tall_launches
    got = lap.lap_jv(cost.to(cuda), m.to(cuda))
    torch.cuda.synchronize()
    assert (lap.jv_launches, lap.jv_tall_launches) == (before + 1, tall + 1)
    torch.testing.assert_close(
        got.cpu(), lap.solve_lap_jv(cost.to(cuda), m.to(cuda)).cpu(),
        rtol=0, atol=0)


@pytest.mark.parametrize("n,q,mmax", [(22, 50, 50), (7, 20, 8), (3, 33, 1)])
def test_lap_auction_kernel_equals_plain(cuda, n, q, mmax):
    cost, m = _lap_problems(n + 100, n, q, mmax)
    before = lap.auction_launches
    got = lap.lap_auction(cost.to(cuda), m.to(cuda))
    torch.cuda.synchronize()
    assert lap.auction_launches == before + 1
    torch.testing.assert_close(
        got.cpu(), lap.solve_lap_auction(cost.to(cuda), m.to(cuda)).cpu(),
        rtol=0, atol=0)


def test_device_match_syncs_nothing(cuda):
    """hungarian_match with the device backends never waits for the card."""
    from monosowa_tpu_torch.models.matcher import (MatcherConfig,
                                                   hungarian_match)

    rng = np.random.default_rng(0)
    args = [torch.from_numpy(a).to(cuda) for a in (
        rng.normal(size=(2, 110, 3)).astype(np.float32),
        rng.uniform(0.1, 0.9, (2, 110, 6)).astype(np.float32),
        rng.integers(0, 3, (2, 8)), rng.uniform(0.1, 0.9, (2, 8, 6)).astype(
            np.float32), np.arange(8)[None, :] < np.array([[3], [5]]))]
    for backend in ("jv", "auction"):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = hungarian_match(*args, MatcherConfig(backend=backend), 10)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert ((got >= 0).sum(1).cpu() == torch.tensor([33, 55])).all()


def test_lap_kernels_refuse_what_they_cannot_take(cuda):
    """The auction refuses more columns than rows, JV counts on another
    device and a cost that is not (N, Q, M); a problem too large for the
    one-warp JV's shared memory is no longer refused: the tall form takes
    it (test_lap_jv_tall_form_equals_plain)."""
    cost = torch.zeros(2, 4, 6, device=cuda)
    m = torch.zeros(2, dtype=torch.int64, device=cuda)
    before = lap.auction_launches, lap.jv_launches
    with pytest.raises(ValueError):
        lap.lap_auction(cost, m)
    with pytest.raises(ValueError):
        lap.lap_jv(cost, m.cpu())
    with pytest.raises(ValueError):
        lap.lap_jv(torch.zeros(300, 300, device=cuda), m[:1])
    assert (lap.auction_launches, lap.jv_launches) == before


def _sam_tree(cfg, seed=0):
    """The port's seeded SAM tree at unit gain (kernels std 1 / sqrt(fan
    in), raw tables N(0, 0.5)), so the logits do not all sit near 0."""
    from monosowa_tpu_torch.convert import zoo_params
    from monosowa_tpu_torch.models.sam import Sam

    rng = np.random.default_rng(seed)

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if key in ("scale", "bias"):
            return node
        std = (1 / np.sqrt(np.prod(node.shape[:-1])) if key == "kernel"
               else 0.5)
        return (std * rng.normal(size=node.shape)).astype(np.float32)

    return walk(zoo_params(Sam(cfg, device="cpu", seed=seed)))


def test_sam_on_the_card_matches_the_cpu(cuda):
    """SAM at test widths (a padded window grid and a global layer): the
    card's low-res masks and IoU within 1e-4 of their magnitude of the
    CPU's, and ``SamRefineBackend``'s masks equal but for at most 4 pixels
    (float32 sums in another order flip a pixel only at a logit near 0)."""
    from monosowa_tpu_torch.convert import load_zoo_params
    from monosowa_tpu_torch.models.sam import (Sam, SamConfig,
                                               SamDecoderConfig,
                                               SamVisionConfig)
    from monosowa_tpu_torch.sowa.masks import SamRefineBackend

    cfg = SamConfig(
        vision=SamVisionConfig(hidden_size=64, num_hidden_layers=3,
                               num_attention_heads=4, image_size=160,
                               patch_size=16, window_size=4,
                               global_attn_indexes=(1,), output_channels=32,
                               mlp_dim=128),
        decoder=SamDecoderConfig(hidden_size=32, num_attention_heads=4,
                                 mlp_dim=64, iou_head_hidden_dim=32),
        prompt_image_size=160, embedding_size=10)
    tree = _sam_tree(cfg)
    models = [load_zoo_params(Sam(cfg, device=d), tree)
              for d in ("cpu", cuda)]
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(1, 160, 160, 3)).astype(
        np.float32))
    boxes = torch.tensor([[[3.0, 4.0, 90.0, 120.0], [40.0, 0.0, 159.0, 60.0],
                           [10.0, 10.0, 30.0, 150.0]]])
    with torch.no_grad():
        out = [m.predict_boxes(x.to(m.vision.patch_proj.weight.device),
                               boxes.to(m.vision.patch_proj.weight.device))
               for m in models]
    for want, got in zip(out[0], out[1]):
        got = got.cpu()
        scale = float(want.abs().max())
        assert scale > 0.1
        assert float((got - want).abs().max()) <= 1e-4 * scale
    img = rng.integers(0, 256, (90, 150, 3), np.uint8)
    box = np.array([[5, 5, 80, 70], [60, 10, 140, 85]])
    got, want = (SamRefineBackend(tree, cfg, max_boxes=1, device=d).refine(
        img, box) for d in (cuda, "cpu"))
    flips = sum(int((a != b).sum()) for a, b in zip(got, want))
    assert flips <= 4 and all(0 < m.mean() < 1 for m in want)


@pytest.mark.parametrize("out_w", [64, 97, 4590])
def test_warp_rules_on_the_card_match_the_cpu(cuda, out_w):
    """``ops/warp.py`` on the card: the warps of uint8 images and float32
    masks equal to the CPU's byte for byte (OpenCV's float32 mapping with
    its fused multiply-adds, each taken in float64); grey and area resize
    equal; the template match at the same location, its map within 1e-12
    of its magnitude (float64 FFTs)."""
    from monosowa_tpu_torch.ops import warp

    rng = np.random.default_rng(out_w)
    img = torch.from_numpy(rng.integers(0, 256, (256, 384, 3), np.uint8))
    mask = torch.from_numpy((rng.uniform(size=(300, 500)) > 0.5).astype(
        np.float32))
    for _ in range(2):
        m = np.eye(3) + np.array([[0.2, 0.1, 30], [0.05, 0.3, 20],
                                  [5e-4, 5e-4, 0]]) * rng.normal(size=(3, 3))
        for src in (img, mask):
            want = warp.cv2_warp_perspective(src, m, (out_w, 211))
            got = warp.cv2_warp_perspective(src.to(cuda), m, (out_w, 211))
            assert torch.equal(got.cpu(), want)
    grey = warp.cv2_rgb2gray(img)
    assert torch.equal(warp.cv2_rgb2gray(img.to(cuda)).cpu(), grey)
    assert torch.equal(warp.cv2_resize_area(grey.to(cuda), (96, 128)).cpu(),
                       warp.cv2_resize_area(grey, (96, 128)))
    win = grey[:120, :150].float()
    tmpl = win[40:70, 50:90].clone() + 0.5
    res, loc = warp.match_template_sqdiff(win, tmpl)
    res_g, loc_g = warp.match_template_sqdiff(win.to(cuda), tmpl.to(cuda))
    assert loc_g == loc == (50, 40)
    assert float((res_g.cpu() - res).abs().max()) <= 1e-12 * float(
        res.abs().max())


def test_loftr_and_tracker_on_the_card_match_the_cpu(cuda):
    """EfficientLoFTR at its full widths with 2 attention layers (seeded
    weights) on a 2 x 192 x 256 pair, and the ViT tracker at its full
    widths: the card's outputs within 1e-4 of the CPU's magnitude.  LoFTR
    runs at a match threshold of 1e-6 (random weights match nothing above
    the shipped 0.2), so that matches exist and their keypoints are held:
    within 1e-4 of the image size where the coarse matches agree; matches
    or keypoints flipped at most on 1% of the coarse cells (a score at the
    threshold, a mutual-nearest tie or the fine stage's argmax flips
    between float32 sums in another order)."""
    from monosowa_tpu_torch.device import resolve_device
    from monosowa_tpu_torch.models.efficientloftr import (
        EfficientLoFTR, EfficientLoFTRConfig)
    from monosowa_tpu_torch.models.vit_tracker import ViTTracker

    resolve_device(cuda)        # TF32 off, as the entry points set it
    cfg = EfficientLoFTRConfig(num_attention_layers=2,
                               coarse_matching_threshold=1e-6)
    models = [EfficientLoFTR(cfg, device=d, seed=0) for d in ("cpu", cuda)]
    rng = np.random.default_rng(2)
    base = rng.uniform(size=(192, 288)).astype(np.float32)
    pair = torch.from_numpy(np.stack([base[:, :256], base[:, 24:280]])[None])
    with torch.no_grad():
        feats = [m.repvgg_forward(pair.reshape(2, 192, 256, 1).to(
            next(m.parameters()).device))[-1] for m in models]
        out = [m(pair.to(next(m.parameters()).device)) for m in models]
    scale = float(feats[0].abs().max())
    assert float((feats[1].cpu() - feats[0]).abs().max()) <= 1e-4 * scale
    (kp, sc, idx), (kp_g, sc_g, idx_g) = out
    same = (idx_g.cpu() == idx) & (idx >= 0)
    assert bool(same.any())
    assert float((sc_g.cpu() - sc)[same].abs().max()) <= 1e-4 * float(
        sc[same].abs().max())
    kp_err = (kp_g.cpu() - kp).abs().amax(-1)[same]
    flips = int((idx_g.cpu() != idx).sum()) + int((kp_err > 1e-4).sum())
    assert flips <= 0.01 * idx.numel()

    trackers = [ViTTracker(device=d, seed=0) for d in ("cpu", cuda)]
    z = torch.from_numpy(rng.normal(size=(1, 128, 128, 3)).astype(
        np.float32))
    x = torch.from_numpy(rng.normal(size=(1, 256, 256, 3)).astype(
        np.float32))
    with torch.no_grad():
        res = [t(z.to(d), x.to(d), t.track_token)
               for t, d in zip(trackers, ("cpu", cuda))]
    for want, got in zip(res[0][1:], res[1][1:]):
        assert float((got.cpu() - want).abs().max()) <= 1e-4 * float(
            want.abs().max())


def _plane_cloud(n, seed):
    """n points on a noisy 100 m x 100 m plane, about 4 within 0.3 m of
    each: components of every size."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(0, 100, n), rng.normal(scale=0.05, size=n),
                    rng.uniform(0, 100, n)], 1).astype(np.float32)
    return pts


def test_growing_on_the_card_matches_the_cpu(cuda):
    """150,000 points: a dense distance matrix would take 90 GB.  The
    voxel mask and the component labels (24 steps) equal the CPU's."""
    from monosowa_tpu_torch.ops.geometry import voxel_downsample_mask
    from monosowa_tpu_torch.sowa import growing

    pts = _plane_cloud(150_000, 0)
    pts[:2000] = np.float32(np.round(pts[:2000] / 0.2)) * np.float32(0.2)
    mask = np.random.default_rng(1).random(len(pts)) < 0.95
    p_cpu, m_cpu = torch.from_numpy(pts), torch.from_numpy(mask)
    p_gpu, m_gpu = p_cpu.to(cuda), m_cpu.to(cuda)
    want = voxel_downsample_mask(p_cpu, m_cpu, 0.2)
    got = voxel_downsample_mask(p_gpu, m_gpu, 0.2)
    assert torch.equal(got.cpu(), want)
    want = growing.connected_components(p_cpu, m_cpu, 0.3)
    got = growing.connected_components(p_gpu, m_gpu, 0.3)
    assert torch.equal(got.cpu(), want)
    assert 1000 < len(torch.unique(want)) < len(pts) // 2
