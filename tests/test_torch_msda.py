"""The torch port's MSDA against the JAX package's MSDA functions.

The port's plain version (``ms_deform_attn_plain``) is what its wrapper runs
for CPU tensors; the CUDA kernel is held against it on the card
(``chip_smoke.py`` and tests/test_torch_cuda.py).  Each comparison with a
JAX function prints its largest difference as a JSON line (shown with
``pytest -s``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monosowa_tpu.models.transformer import MSDeformAttnModule as JaxMSDA
from monosowa_tpu.ops.msda import ms_deform_attn as jax_msda
from monosowa_tpu.ops.msda_mxu import ms_deform_attn_mxu
from monosowa_tpu.ops.msda_pallas import ms_deform_attn_pallas
from monosowa_tpu_torch.convert import load_flax_params
from monosowa_tpu_torch.models.transformer import MSDeformAttnModule
from monosowa_tpu_torch.ops import msda

SHAPES = ((12, 20), (6, 10), (3, 5), (2, 3))


def _inputs(seed, q, b=2, m=4, d=8, p=4):
    """loc in [-0.15, 1.15] so out-of-bounds corners are covered."""
    rng = np.random.default_rng(seed)
    s = sum(h * w for h, w in SHAPES)
    value = rng.normal(size=(b, s, m, d)).astype(np.float32)
    loc = rng.uniform(-0.15, 1.15, (b, q, m, len(SHAPES), p, 2)
                      ).astype(np.float32)
    w = rng.uniform(0, 1, (b, q, m, len(SHAPES), p)).astype(np.float32)
    w /= w.reshape(b, q, m, -1).sum(-1).reshape(b, q, m, 1, 1)
    return value, loc, w


def _plain(value, loc, w):
    return msda.ms_deform_attn_plain(torch.from_numpy(value), SHAPES,
                                     torch.from_numpy(loc),
                                     torch.from_numpy(w)).numpy()


def _report(against, got, want, relative=False):
    diff = float(np.abs(got - want).max())
    key = "max_abs"
    if relative:
        diff, key = diff / float(np.abs(want).max()), "max_rel"
    print(json.dumps({"plain_vs": against, key: diff}))


# 37 and 130 queries: multiples of no block size (64, 256) of K1/K4
@pytest.mark.parametrize("q", [37, 130])
@pytest.mark.parametrize("gather_mode", ["quad", "corner"])
def test_plain_matches_xla(q, gather_mode):
    value, loc, w = _inputs(0, q)
    want = np.asarray(jax_msda(jnp.asarray(value), SHAPES, jnp.asarray(loc),
                               jnp.asarray(w), gather_mode=gather_mode))
    got = _plain(value, loc, w)
    _report(f"xla {gather_mode} q={q}", got, want)
    np.testing.assert_allclose(got, want, atol=2e-5)


# K1 casts value to bf16 (msda_mxu.py:235): the bar of test_msda_mxu.py
@pytest.mark.parametrize("q", [37, 130])
def test_plain_matches_mxu_kernel(q):
    value, loc, w = _inputs(1, q)
    want = np.asarray(ms_deform_attn_mxu(
        jnp.asarray(value), SHAPES, jnp.asarray(loc), jnp.asarray(w),
        block_q=64, block_t=64, interpret=True))
    got = _plain(value, loc, w)
    _report(f"mxu interpret q={q}", got, want)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


# K4 casts value to bf16 too (msda_pallas.py:98)
@pytest.mark.parametrize("q", [37])
def test_plain_matches_pallas_kernel(q):
    value, loc, w = _inputs(2, q, b=1, m=2)
    want = np.asarray(ms_deform_attn_pallas(
        jnp.asarray(value), SHAPES, jnp.asarray(loc), jnp.asarray(w),
        block_q=16, interpret=True))
    got = _plain(value, loc, w)
    _report(f"pallas interpret q={q}", got, want)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


def test_wrapper_runs_plain_version_on_cpu():
    value, loc, w = _inputs(3, 11)
    before = msda.launches
    got = msda.ms_deform_attn(torch.from_numpy(value), SHAPES,
                              torch.from_numpy(loc), torch.from_numpy(w))
    assert msda.launches == before       # no kernel launch for CPU tensors
    np.testing.assert_array_equal(got.numpy(), _plain(value, loc, w))


def test_wrapper_rejects_bad_inputs():
    value, loc, w = (torch.from_numpy(a) for a in _inputs(4, 5))
    with pytest.raises(TypeError):
        msda.ms_deform_attn(value.double(), SHAPES, loc, w)
    with pytest.raises(ValueError):
        msda.ms_deform_attn(value, SHAPES[:3], loc, w)
    with pytest.raises(ValueError):
        msda.ms_deform_attn(value, SHAPES, loc, w[:, :3])


@pytest.mark.parametrize("ref_dof", [2, 6])
def test_module_matches_jax(ref_dof):
    """MSDeformAttnModule through the weight bridge, in both reference-point
    branches (transformer.py:93-102), with random (not zero) offset and
    attention-weight heads so the samples spread."""
    rng = np.random.default_rng(5)
    b, q, d, m, p = 2, 29, 32, 4, 4
    s = sum(h * w for h, w in SHAPES)
    query = rng.normal(size=(b, q, d)).astype(np.float32)
    src = rng.normal(size=(b, s, d)).astype(np.float32)
    ref = rng.uniform(0.05, 0.95, (b, q, len(SHAPES), ref_dof)
                      ).astype(np.float32)
    if ref_dof == 6:
        ref[..., 2:] *= 0.2
    jm = JaxMSDA(d_model=d, n_levels=len(SHAPES), n_heads=m, n_points=p,
                 backend="xla")
    params = jm.init(jax.random.PRNGKey(0), query, ref, src, SHAPES)["params"]
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(
            np.float32), params)
    want = np.asarray(jm.apply({"params": params}, query, ref, src, SHAPES))

    tm = MSDeformAttnModule(torch.Generator().manual_seed(0), d,
                            len(SHAPES), m, p)
    load_flax_params(tm, params)
    with torch.no_grad():
        got = tm(torch.from_numpy(query), torch.from_numpy(ref),
                 torch.from_numpy(src), SHAPES).numpy()
    _report(f"module ref_dof={ref_dof}", got, want, relative=True)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-4)


def test_module_on_pixel_grid_matches_jax():
    """At its init (zero offset kernel, ring-pattern bias) the encoder's
    MSDA samples pixel-centre reference points plus whole-pixel offsets,
    so many sampling coordinates land exactly on the integer grid, where
    floor() decides the corner.  The port agrees with the JAX module run op
    by op."""
    from monosowa_tpu.models.transformer import encoder_reference_points

    rng = np.random.default_rng(7)
    b, d, m, p = 2, 64, 4, 4
    s = sum(h * w for h, w in SHAPES)
    src = rng.normal(size=(b, s, d)).astype(np.float32)
    ref = np.broadcast_to(encoder_reference_points(SHAPES)[None],
                          (b, s, len(SHAPES), 2)).astype(np.float32)
    jm = JaxMSDA(d_model=d, n_levels=len(SHAPES), n_heads=m, n_points=p,
                 backend="xla")
    params = jm.init(jax.random.PRNGKey(0), src, ref, src, SHAPES)["params"]
    want = np.asarray(jm.apply({"params": params}, src, ref, src, SHAPES))

    tm = MSDeformAttnModule(torch.Generator().manual_seed(0), d,
                            len(SHAPES), m, p)
    load_flax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    with torch.no_grad():
        got = tm(torch.from_numpy(src), torch.from_numpy(ref),
                 torch.from_numpy(src), SHAPES).numpy()
    _report("module on the pixel grid", got, want, relative=True)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-4)


# ---------------------------------------------------------------------------
# bfloat16 value rows, as K1-K4 read them on the TPU
# ---------------------------------------------------------------------------

def _bf16(value):
    """value rounded to bfloat16: the torch tensor and the same bits as a
    JAX array."""
    tv = torch.from_numpy(value).to(torch.bfloat16)
    return tv, jnp.asarray(tv.float().numpy()).astype(jnp.bfloat16)


def _plain_bf16(tv, loc, w):
    out = msda.ms_deform_attn_plain(tv, SHAPES, torch.from_numpy(loc),
                                    torch.from_numpy(w))
    assert out.dtype == torch.float32
    return out.numpy()


def _close_bf16(got, want, what):
    """Both read the same bf16 rows and sum in float32, in another order:
    2e-5 of the output's largest magnitude."""
    scale = float(np.abs(want).max())
    _report(what, got, want, relative=True)
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-5)


# K1 itself (msda_mxu.py:235 casts value to bf16, sums in float32)
@pytest.mark.parametrize("q", [37, 130])
def test_plain_bf16_matches_mxu_kernel(q):
    value, loc, w = _inputs(8, q)
    tv, jv = _bf16(value)
    want = np.asarray(ms_deform_attn_mxu(
        jv, SHAPES, jnp.asarray(loc), jnp.asarray(w), block_q=64,
        block_t=64, interpret=True))
    assert want.dtype == np.float32
    _close_bf16(_plain_bf16(tv, loc, w), want, f"bf16 mxu interpret q={q}")


# K4 (msda_pallas.py:98 casts value to bf16)
def test_plain_bf16_matches_pallas_kernel():
    value, loc, w = _inputs(9, 37, b=1, m=2)
    tv, jv = _bf16(value)
    want = np.asarray(ms_deform_attn_pallas(
        jv, SHAPES, jnp.asarray(loc), jnp.asarray(w), block_q=16,
        interpret=True))
    _close_bf16(_plain_bf16(tv, loc, w), want, "bf16 pallas interpret q=37")


# the XLA quad path on a bf16 value: jnp promotes bf16 x f32 to float32
@pytest.mark.parametrize("q", [37, 130])
def test_plain_bf16_matches_xla_quad(q):
    value, loc, w = _inputs(10, q)
    tv, jv = _bf16(value)
    want = np.asarray(jax_msda(jv, SHAPES, jnp.asarray(loc), jnp.asarray(w),
                               gather_mode="quad"))
    assert want.dtype == np.float32
    _close_bf16(_plain_bf16(tv, loc, w), want, f"bf16 xla quad q={q}")


def test_wrapper_takes_bf16_value_with_float32_loc_and_aw():
    value, loc, w = _inputs(11, 11)
    tv = torch.from_numpy(value).to(torch.bfloat16)
    tl, tw = torch.from_numpy(loc), torch.from_numpy(w)
    before = (msda.launches, msda.launches_bf16)
    got = msda.ms_deform_attn(tv, SHAPES, tl, tw)
    assert (msda.launches, msda.launches_bf16) == before   # CPU: no kernel
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), _plain_bf16(tv, loc, w))
    # loc and aw stay float32 whatever value's dtype; no float16 at all
    for args in ((tv, tl.to(torch.bfloat16), tw),
                 (tv, tl, tw.to(torch.bfloat16)), (tv, tl.double(), tw),
                 (tv.half(), tl, tw)):
        with pytest.raises(TypeError):
            msda.ms_deform_attn(args[0], SHAPES, args[1], args[2])
