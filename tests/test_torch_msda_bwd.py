"""The torch port's MSDA backward against the JAX package's.

The plain backward (``msda_grad_loc_aw_plain``, ``msda_grad_value_plain``)
is what ``MSDAFunction`` runs for CPU tensors; the CUDA kernel
``csrc/msda_bwd.cu`` is held against it on the card (``chip_smoke.py`` and
tests/test_torch_cuda.py).  Here the plain backward meets the JAX package's
hand-written VJP (``ops/msda.py`` ``_msda_bwd``), its two TPU kernels in
interpret mode (K2 ``msda_gdot_mxu`` with the fold of ``ops/msda.py:311-324``,
K3 ``msda_dvalue_mxu``), and torch.autograd through the plain forward.
Each comparison with a JAX function prints its largest difference relative
to the output's largest magnitude as a JSON line (``pytest -s``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monosowa_tpu.models.transformer import MSDeformAttnModule as JaxMSDA
from monosowa_tpu.ops.msda import _quad_slot_geometry
from monosowa_tpu.ops.msda import ms_deform_attn as jax_msda
from monosowa_tpu.ops.msda_mxu import msda_dvalue_mxu, msda_gdot_mxu
from monosowa_tpu_torch.convert import load_flax_params
from monosowa_tpu_torch.models.transformer import MSDeformAttnModule
from monosowa_tpu_torch.ops import msda
from monosowa_tpu_torch.utils import timing

SHAPES = ((12, 20), (6, 10), (3, 5), (2, 3))
NAMES = ("dvalue", "dloc", "daw")


def _inputs(seed, q, b=2, m=4, d=8, p=4, shapes=SHAPES):
    """value, loc in [-0.15, 1.15] (out-of-bounds corners covered), aw
    normalised over the samples, and an incoming gradient."""
    rng = np.random.default_rng(seed)
    s = sum(h * w for h, w in shapes)
    value = rng.normal(size=(b, s, m, d)).astype(np.float32)
    loc = rng.uniform(-0.15, 1.15, (b, q, m, len(shapes), p, 2)
                      ).astype(np.float32)
    aw = rng.uniform(0, 1, (b, q, m, len(shapes), p)).astype(np.float32)
    aw /= aw.reshape(b, q, m, -1).sum(-1).reshape(b, q, m, 1, 1)
    dout = rng.normal(size=(b, q, m * d)).astype(np.float32)
    return value, loc, aw, dout


def _plain_bwd(value, loc, aw, dout, shapes=SHAPES):
    t = [torch.from_numpy(a) for a in (value, loc, aw, dout)]
    dloc, daw = msda.msda_grad_loc_aw_plain(t[0], shapes, t[1], t[2], t[3])
    dvalue = msda.msda_grad_value_plain(value.shape, shapes, t[1], t[2],
                                        t[3])
    return dvalue.numpy(), dloc.numpy(), daw.numpy()


def _close(got, want, tol, what):
    """Asserts agreement within ``tol`` of want's largest magnitude and
    prints the largest difference relative to it."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-12)
    rel = float(np.abs(got - want).max()) / scale
    print(json.dumps({"plain_bwd_vs": what, "max_rel": rel}))
    np.testing.assert_allclose(got / scale, want / scale, atol=tol,
                               err_msg=what)


# the analytic backward's bar against autodiff, tests/test_msda.py:117
@pytest.mark.parametrize("q", [37, 130])
@pytest.mark.parametrize("gather_mode", ["quad", "corner"])
def test_plain_bwd_matches_jax_vjp(q, gather_mode):
    value, loc, aw, dout = _inputs(0, q)
    _, vjp = jax.vjp(lambda v, l, a: jax_msda(v, SHAPES, l, a,
                                              gather_mode=gather_mode),
                     jnp.asarray(value), jnp.asarray(loc), jnp.asarray(aw))
    want = vjp(jnp.asarray(dout))
    got = _plain_bwd(value, loc, aw, dout)
    for g, w, name in zip(got, want, NAMES):
        _close(g, w, 2e-4, f"jax _msda_bwd {gather_mode} q={q} {name}")


def _jax_fold(gdot, loc, aw):
    """ops/msda.py:311-324: K2's slot dots -> dLoc, dAttn."""
    dls, dws = [], []
    for lvl, (h, w_l) in enumerate(SHAPES):
        _, slot_w, slot_dwx, slot_dwy = _quad_slot_geometry(
            loc[:, :, :, lvl], h, w_l)
        g = gdot[:, :, :, lvl]
        aw_l = aw[:, :, :, lvl]
        dws.append(jnp.einsum("bqmps,bqmps->bqmp", slot_w, g))
        dls.append(jnp.stack(
            [aw_l * w_l * jnp.einsum("bqmps,bqmps->bqmp", slot_dwx, g),
             aw_l * h * jnp.einsum("bqmps,bqmps->bqmp", slot_dwy, g)], -1))
    return jnp.stack(dls, 3), jnp.stack(dws, 3)


# K2 and K3 read value and dout in bf16: the bf16 bar of test_msda_mxu.py
@pytest.mark.parametrize("q", [37, 130])
def test_plain_bwd_matches_gdot_kernel(q):
    value, loc, aw, dout = _inputs(1, q)
    b, _, m, d = value.shape
    gdot = msda_gdot_mxu(jnp.asarray(value), SHAPES, jnp.asarray(loc),
                         jnp.asarray(dout.reshape(b, q, m, d)), block_q=64,
                         block_t=64, interpret=True)
    want = _jax_fold(gdot, jnp.asarray(loc), jnp.asarray(aw))
    _, dloc, daw = _plain_bwd(value, loc, aw, dout)
    _close(dloc, want[0], 2e-2, f"K2 msda_gdot_mxu + fold q={q} dloc")
    _close(daw, want[1], 2e-2, f"K2 msda_gdot_mxu + fold q={q} daw")


@pytest.mark.parametrize("q", [37, 130])
def test_plain_bwd_matches_dvalue_kernel(q):
    value, loc, aw, dout = _inputs(2, q)
    b, _, m, d = value.shape
    want = msda_dvalue_mxu(SHAPES, jnp.asarray(loc), jnp.asarray(aw),
                           jnp.asarray(dout.reshape(b, q, m, d)),
                           block_q=64, block_t=64, interpret=True)
    dvalue, _, _ = _plain_bwd(value, loc, aw, dout)
    _close(dvalue, want, 2e-2, f"K3 msda_dvalue_mxu q={q}")


def _autograd(value, loc, aw, dout, shapes):
    t = [torch.from_numpy(a).requires_grad_() for a in (value, loc, aw)]
    out = msda.ms_deform_attn_plain(t[0], shapes, t[1], t[2])
    return [g.numpy() for g in torch.autograd.grad(
        out, t, torch.from_numpy(dout))]


# float32 sums in another order: 1e-5 of each output's magnitude; P=3 and a
# 1-row level cover the loop edges
@pytest.mark.parametrize("shapes,q,m,d,p", [
    (SHAPES, 53, 4, 8, 4),
    (((7, 9), (1, 5)), 21, 2, 16, 3),
])
def test_plain_bwd_matches_autograd(shapes, q, m, d, p):
    value, loc, aw, dout = _inputs(3, q, m=m, d=d, p=p, shapes=shapes)
    want = _autograd(value, loc, aw, dout, shapes)
    got = _plain_bwd(value, loc, aw, dout, shapes)
    for g, w, name in zip(got, want, NAMES):
        _close(g, w, 1e-5, f"torch.autograd {name}")


def test_plain_bwd_on_pixel_grid_matches_autograd():
    """Sampling points on the integer pixel grid, as at the encoder's init
    (ring-pattern offsets from pixel centres): floor() picks the corner,
    and the analytic backward takes the same one-sided derivative as
    autograd through the gathers."""
    from monosowa_tpu_torch.models.transformer import (
        encoder_reference_points, ring_bias)

    rng = np.random.default_rng(4)
    b, m, d, p = 1, 4, 8, 4
    s = sum(h * w for h, w in SHAPES)
    ref = encoder_reference_points(SHAPES)[None]              # (1,S,L,2)
    norm = np.array([[w, h] for h, w in SHAPES], np.float32)
    offs = ring_bias(m, len(SHAPES), p).reshape(1, 1, m, len(SHAPES), p, 2)
    loc = (ref[:, :, None, :, None, :] + offs / norm[:, None, :]
           ).astype(np.float32)
    value = rng.normal(size=(b, s, m, d)).astype(np.float32)
    aw = np.full((b, s, m, len(SHAPES), p), 1.0 / 16, np.float32)
    dout = rng.normal(size=(b, s, m * d)).astype(np.float32)
    want = _autograd(value, loc, aw, dout, SHAPES)
    got = _plain_bwd(value, loc, aw, dout)
    for g, w, name in zip(got, want, NAMES):
        _close(g, w, 1e-5, f"torch.autograd on the pixel grid {name}")


def test_msda_function_gradcheck():
    """MSDAFunction's backward in float64 against finite differences."""
    shapes = ((3, 4), (2, 2))
    rng = np.random.default_rng(5)
    b, q, m, d, p = 1, 3, 2, 3, 2
    s = sum(h * w for h, w in shapes)
    value = torch.from_numpy(rng.normal(size=(b, s, m, d)))
    # inside [0.05, 0.95] and off the pixel grid: finite differences of
    # eps 1e-6 stay within one bilinear cell
    loc = torch.from_numpy(rng.uniform(0.05, 0.95, (b, q, m, 2, p, 2)))
    aw = torch.from_numpy(rng.uniform(0, 1, (b, q, m, 2, p)))
    args = [t.requires_grad_() for t in (value, loc, aw)]
    assert torch.autograd.gradcheck(
        lambda v, l, a: msda.MSDAFunction.apply(v, l, a, shapes), args,
        eps=1e-6, atol=1e-6, rtol=1e-5)


def test_wrapper_output_carries_grad_fn_on_cpu():
    value, loc, aw, dout = (torch.from_numpy(a) for a in _inputs(6, 9))
    value.requires_grad_()
    loc.requires_grad_()
    aw.requires_grad_()
    names = ("msda.fwd_launches", "msda.bwd_launches")
    before = [timing.counter(n) for n in names]
    out = msda.ms_deform_attn(value, SHAPES, loc, aw)
    assert out.grad_fn is not None
    out.backward(dout)
    # no kernels here
    assert [timing.counter(n) for n in names] == before
    want = _plain_bwd(*(t.detach().numpy() for t in (value, loc, aw, dout)))
    for t, w in zip((value, loc, aw), want):
        np.testing.assert_array_equal(t.grad.numpy(), w)


@pytest.mark.parametrize("ref_dof", [2, 6])
def test_module_grads_match_jax(ref_dof):
    """MSDeformAttnModule through the weight bridge: the gradients of every
    parameter and of query, reference points and src against jax.grad of
    the JAX module (op by op, random heads so the samples spread), at
    2e-4 of each gradient's scale."""
    rng = np.random.default_rng(7)
    b, q, d, m, p = 2, 29, 32, 4, 4
    s = sum(h * w for h, w in SHAPES)
    query = rng.normal(size=(b, q, d)).astype(np.float32)
    src = rng.normal(size=(b, s, d)).astype(np.float32)
    ref = rng.uniform(0.05, 0.95, (b, q, len(SHAPES), ref_dof)
                      ).astype(np.float32)
    if ref_dof == 6:
        ref[..., 2:] *= 0.2
    dout = rng.normal(size=(b, q, d)).astype(np.float32)
    jm = JaxMSDA(d_model=d, n_levels=len(SHAPES), n_heads=m, n_points=p,
                 backend="xla")
    params = jm.init(jax.random.PRNGKey(0), query, ref, src, SHAPES)["params"]
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(
            np.float32), params)

    def loss(params, query, ref, src):
        out = jm.apply({"params": params}, query, ref, src, SHAPES)
        return jnp.sum(out * dout)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(params, query, ref, src)

    tm = MSDeformAttnModule(torch.Generator().manual_seed(0), d,
                            len(SHAPES), m, p)
    load_flax_params(tm, params)
    inputs = [torch.from_numpy(a).requires_grad_() for a in (query, ref, src)]
    (tm(inputs[0], inputs[1], inputs[2], SHAPES)
     * torch.from_numpy(dout)).sum().backward()
    for name in ("value_proj", "sampling_offsets", "attention_weights",
                 "output_proj"):
        lin = getattr(tm, name)
        _close(lin.weight.grad.numpy().T, want[0][name]["kernel"], 2e-4,
               f"module ref_dof={ref_dof} {name}.kernel")
        _close(lin.bias.grad.numpy(), want[0][name]["bias"], 2e-4,
               f"module ref_dof={ref_dof} {name}.bias")
    for t, w, name in zip(inputs, want[1:], ("query", "ref", "src")):
        _close(t.grad.numpy(), w, 2e-4, f"module ref_dof={ref_dof} d{name}")


# ---------------------------------------------------------------------------
# bfloat16 value rows: the plain backward against K1-K3 through the JAX
# package's custom VJP (gather_mode "mxu", interpreted, as
# tests/test_msda_mxu.py:96-127 runs it) and its XLA quad path
# ---------------------------------------------------------------------------

def _bf16_inputs(seed, q):
    value, loc, aw, dout = _inputs(seed, q)
    tv = torch.from_numpy(value).to(torch.bfloat16)
    return tv, tv.float().numpy(), loc, aw, dout


def _jax_bf16_vjp(value32, loc, aw, dout, gather_mode):
    jv = jnp.asarray(value32).astype(jnp.bfloat16)
    out, vjp = jax.vjp(lambda v, l, a: jax_msda(v, SHAPES, l, a,
                                                gather_mode=gather_mode),
                       jv, jnp.asarray(loc), jnp.asarray(aw))
    assert out.dtype == jnp.float32
    return vjp(jnp.asarray(dout))


def _plain_bf16_bwd(tv, loc, aw, dout):
    """MSDAFunction's backward on the CPU for a bf16 value."""
    t = [tv.clone().requires_grad_()] + [
        torch.from_numpy(a).requires_grad_() for a in (loc, aw)]
    out = msda.ms_deform_attn(t[0], SHAPES, t[1], t[2])
    out.backward(torch.from_numpy(dout))
    assert (t[0].grad.dtype, t[1].grad.dtype, t[2].grad.dtype) == (
        torch.bfloat16, torch.float32, torch.float32)
    return [x.grad.float().numpy() for x in t]


def _within_one_ulp(got, want, what):
    """got and want both bf16 roundings of float32 sums taken in other
    orders: at most one bf16 step (2**-7 of the power of two below the
    larger magnitude) apart, element by element."""
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    diff = np.abs(got - want)
    print(json.dumps({"plain_bwd_vs": what, "max_ulps":
                      float((diff / ulp).max()),
                      "elements_off_by_one_ulp": int((diff > 0).sum())}))
    assert (diff <= ulp).all(), what


@pytest.mark.parametrize("q", [37, 130])
def test_plain_bf16_bwd_matches_mxu_kernels(q):
    tv, value32, loc, aw, dout = _bf16_inputs(12, q)
    want = _jax_bf16_vjp(value32, loc, aw, dout, "mxu")
    assert want[0].dtype == jnp.bfloat16          # K3's sums cast (:635)
    got = _plain_bf16_bwd(tv, loc, aw, dout)
    # K2 reads the same bf16 rows and sums float32 products
    _close(got[1], want[1], 2e-4, f"bf16 K2 + fold q={q} dloc")
    _close(got[2], want[2], 2e-4, f"bf16 K2 + fold q={q} daw")
    # K3 rounds its payload to bf16 (msda_mxu.py:494): its own bar
    _close(got[0], np.asarray(want[0], np.float32), 5e-2,
           f"bf16 K3 q={q} dvalue")


@pytest.mark.parametrize("q", [37, 130])
def test_plain_bf16_bwd_matches_xla_quad(q):
    tv, value32, loc, aw, dout = _bf16_inputs(13, q)
    want = _jax_bf16_vjp(value32, loc, aw, dout, "quad")
    got = _plain_bf16_bwd(tv, loc, aw, dout)
    _within_one_ulp(got[0], np.asarray(want[0], np.float32),
                    f"bf16 xla quad q={q} dvalue")
    _close(got[1], want[1], 2e-4, f"bf16 xla quad q={q} dloc")
    _close(got[2], want[2], 2e-4, f"bf16 xla quad q={q} daw")


def test_plain_bf16_bwd_is_the_float32_sum_rounded_once():
    """dloc and daw of a bf16 value are those of its float32 copy, and
    dvalue is their float32 sum rounded to bf16 once."""
    tv, value32, loc, aw, dout = _bf16_inputs(14, 53)
    got = _plain_bf16_bwd(tv, loc, aw, dout)
    want = _plain_bwd(value32, loc, aw, dout)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(
        got[0], torch.from_numpy(want[0]).to(torch.bfloat16).float().numpy())
