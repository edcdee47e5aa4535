"""The port's CUDA kernels against their plain versions, on a GPU.

Every test here is marked ``cuda`` and skips without a GPU: a CUDA kernel
has no CPU mode.  The file imports no JAX, so it also runs on a machine
without it (``--noconftest`` skips the suite's JAX setup):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from monosowa_tpu_torch.ops import msda

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
