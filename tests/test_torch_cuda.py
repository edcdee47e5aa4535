"""The port's CUDA kernels against their plain versions, on a GPU.

Every test here is marked ``cuda`` and skips without a GPU: a CUDA kernel
has no CPU mode.  The file imports no JAX, so it also runs on a machine
without it (``--noconftest`` skips the suite's JAX setup):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from monosowa_tpu_torch.ops import msda, row_fetch, tfl

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


# D=8 leaves lanes idle, D=32 fills the warp, D=48 takes two channel passes;
# a 1-row level and P=3 (12 samples) cover the loop edges
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


# the forward's shapes: lanes idle, a full warp, two channel passes, a
# 1-row level and P=3; float32 sums in another order (dvalue's atomics in
# an order that changes from run to run): 1e-5 of each output's magnitude
@pytest.mark.parametrize("shapes,q,m,d,p", [
    (((12, 20), (6, 10), (3, 5), (2, 3)), 130, 4, 8, 4),
    (((48, 160), (24, 80), (12, 40), (6, 20)), 550, 8, 32, 4),
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
