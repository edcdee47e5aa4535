"""The explicit MSDA backends (``mxu``, ``pallas``, ``onehot``) of the port
against the JAX package's.

The JAX backends read bfloat16 value rows whatever the compute dtype (K1's
bf16 quad rows, ``ops/msda_mxu.py:235``; K4's ``value.astype(bfloat16)``,
``ops/msda_pallas.py:98``; the one-hot gathers' bf16 operands,
``ops/msda.py:157-205``); the port's ``MSDeformAttnModule`` rounds value to
bfloat16 before the MSDA under these three backends, and on the CPU runs the
plain version on those rows.  Here: the plain version on bf16 rows against
the JAX one-hot MSDA (forward and custom VJP), each backend's module against
the JAX module with the same backend (Pallas interpreted, as
tests/test_torch_msda.py runs it), and a whole model built with
``msda_backend: onehot`` against the JAX model built from the same model
section.  Each comparison prints its numbers as a JSON line (``pytest -s``).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monosowa_tpu.models.monodetr import build_monodetr as jax_build
from monosowa_tpu.models.transformer import MSDeformAttnModule as JaxMSDA
from monosowa_tpu.ops import msda_pallas as jax_msda_pallas
from monosowa_tpu.ops.msda import ms_deform_attn as jax_msda
from monosowa_tpu_torch.convert import load_flax_params
from monosowa_tpu_torch.models.monodetr import build_monodetr
from monosowa_tpu_torch.models.transformer import (BF16_ROW_BACKENDS,
                                                   MSDeformAttnModule,
                                                   bf16_rows)
from monosowa_tpu_torch.ops import msda
from monosowa_tpu_torch.train.sample import sample_batch
from test_torch_slice import _spread_offsets
from test_torch_train import _one_torch_thread  # noqa: F401 (autouse)

# every level at least 2 rows: the JAX quad and one-hot gathers raise on a
# level with one row
SHAPES = ((12, 20), (6, 10), (3, 5), (2, 3))
MODEL_INPUTS = ("image", "calib", "img_size")
HEADS = ("pred_logits", "pred_boxes", "pred_depth")


def _inputs(seed, q, b=2, m=4, d=8, p=4):
    """value, loc in [-0.15, 1.15] (out-of-bounds corners covered), aw
    normalised over the samples, and an incoming gradient."""
    rng = np.random.default_rng(seed)
    s = sum(h * w for h, w in SHAPES)
    value = rng.normal(size=(b, s, m, d)).astype(np.float32)
    loc = rng.uniform(-0.15, 1.15, (b, q, m, len(SHAPES), p, 2)
                      ).astype(np.float32)
    aw = rng.uniform(0, 1, (b, q, m, len(SHAPES), p)).astype(np.float32)
    aw /= aw.reshape(b, q, m, -1).sum(-1).reshape(b, q, m, 1, 1)
    dout = rng.normal(size=(b, q, m * d)).astype(np.float32)
    return value, loc, aw, dout


def _close(got, want, tol, what):
    """Asserts agreement within ``tol`` of want's largest magnitude and
    prints the largest difference relative to it."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-12)
    rel = float(np.abs(got - want).max()) / scale
    print(json.dumps({"port_vs": what, "max_rel": rel, "bar": tol}))
    np.testing.assert_allclose(got / scale, want / scale, atol=tol,
                               err_msg=what)


def _jax_onehot(value, loc, aw):
    return jax_msda(value, SHAPES, loc, aw, gather_mode="onehot",
                    onehot_dtype="bfloat16")


def _port(value, loc, aw):
    """MSDeformAttnModule's path under a bf16-row backend: value rounded to
    bf16, then ``ms_deform_attn`` (the plain version on the CPU)."""
    return msda.ms_deform_attn(bf16_rows(value), SHAPES, loc, aw)


@pytest.mark.parametrize("q", [37, 130])
def test_plain_bf16_matches_onehot_forward(q):
    value, loc, aw, _ = _inputs(20, q)
    want = np.asarray(_jax_onehot(jnp.asarray(value), jnp.asarray(loc),
                                  jnp.asarray(aw)))
    assert want.dtype == np.float32
    got = _port(*[torch.from_numpy(a) for a in (value, loc, aw)])
    assert got.dtype == torch.float32
    # the same bf16 rows, float32 sums in another order
    _close(got.numpy(), want, 2e-5, f"onehot forward q={q}")


@pytest.mark.parametrize("q", [37, 130])
def test_plain_bf16_matches_onehot_backward(q):
    """The JAX custom VJP of the one-hot MSDA against the port's backward
    through the bf16 cast: dloc and daw read the same bf16 rows (2e-4, the
    analytic backward's bar); the JAX dvalue rounds its payloads to bf16
    before the one-hot dots (``ops/msda.py:440-447``), the port sums in
    float32 and rounds once, so dvalue holds to K3's bar, 5e-2."""
    value, loc, aw, dout = _inputs(21, q)
    _, vjp = jax.vjp(_jax_onehot, jnp.asarray(value), jnp.asarray(loc),
                     jnp.asarray(aw))
    want = vjp(jnp.asarray(dout))
    assert want[0].dtype == jnp.float32
    t = [torch.from_numpy(a).requires_grad_() for a in (value, loc, aw)]
    _port(*t).backward(torch.from_numpy(dout))
    assert all(x.grad.dtype == torch.float32 for x in t)
    _close(t[1].grad.numpy(), want[1], 2e-4, f"onehot q={q} dloc")
    _close(t[2].grad.numpy(), want[2], 2e-4, f"onehot q={q} daw")
    _close(t[0].grad.numpy(), want[0], 5e-2, f"onehot q={q} dvalue")


@pytest.fixture
def interpreted_pallas(monkeypatch):
    """The JAX module's ``pallas`` backend in interpret mode (it imports
    ``ms_deform_attn_pallas`` at each call); ``mxu`` interprets by itself
    off the TPU."""
    monkeypatch.setattr(jax_msda_pallas, "ms_deform_attn_pallas",
                        functools.partial(
                            jax_msda_pallas.ms_deform_attn_pallas,
                            block_q=16, interpret=True))


@pytest.mark.parametrize("backend", ["mxu", "pallas", "onehot"])
def test_module_reads_bf16_rows_as_jax(backend, interpreted_pallas):
    """MSDeformAttnModule under float32 with each bf16-row backend against
    the JAX module with the same backend, random offset and attention
    heads: 2e-5 of scale (the same bf16 rows, float32 sums)."""
    rng = np.random.default_rng(22)
    b, q, d, m, p = 1, 29, 32, 2, 4
    s = sum(h * w for h, w in SHAPES)
    query = rng.normal(size=(b, q, d)).astype(np.float32)
    src = rng.normal(size=(b, s, d)).astype(np.float32)
    ref = rng.uniform(0.05, 0.95, (b, q, len(SHAPES), 2)).astype(np.float32)
    jm = JaxMSDA(d_model=d, n_levels=len(SHAPES), n_heads=m, n_points=p,
                 backend=backend)
    params = JaxMSDA(d_model=d, n_levels=len(SHAPES), n_heads=m, n_points=p,
                     backend="xla").init(jax.random.PRNGKey(0), query, ref,
                                         src, SHAPES)["params"]
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(
            np.float32), params)
    want = np.asarray(jm.apply({"params": params}, query, ref, src, SHAPES))

    tm = MSDeformAttnModule(torch.Generator().manual_seed(0), d,
                            len(SHAPES), m, p, backend=backend,
                            compute_dtype="float32")
    load_flax_params(tm, params)
    seen = []

    def recording(value, shapes, loc, aw):
        seen.append(value.dtype)
        return msda.ms_deform_attn(value, shapes, loc, aw)

    tm.msda = recording
    with torch.no_grad():
        got = tm(torch.from_numpy(query), torch.from_numpy(ref),
                 torch.from_numpy(src), SHAPES).numpy()
    assert seen == [torch.bfloat16]
    _close(got, want, 2e-5, f"module backend={backend}")


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_auto_and_xla_keep_the_compute_dtype(backend):
    assert backend not in BF16_ROW_BACKENDS
    tm = MSDeformAttnModule(torch.Generator().manual_seed(0), 32,
                            len(SHAPES), 2, 4, backend=backend,
                            compute_dtype="float32")
    seen = []
    tm.msda = lambda v, *a: seen.append(v.dtype) or msda.ms_deform_attn(
        v, *a)
    s = sum(h * w for h, w in SHAPES)
    with torch.no_grad():
        tm(torch.zeros(1, 5, 32), torch.full((1, 5, len(SHAPES), 2), 0.5),
           torch.ones(1, s, 32), SHAPES)
    assert seen == [torch.float32]


def test_float64_module_reads_the_same_rounded_rows():
    """A float64 model (on the CPU) under a bf16-row backend reads value
    rounded to bf16 and sums in float64."""
    value, loc, aw, _ = _inputs(23, 11)
    v64 = torch.from_numpy(value).double()
    rows = bf16_rows(v64)
    assert rows.dtype == torch.float64
    np.testing.assert_array_equal(rows.numpy(), torch.from_numpy(
        value).to(torch.bfloat16).double().numpy())
    got = msda.ms_deform_attn(rows, SHAPES, torch.from_numpy(loc).double(),
                              torch.from_numpy(aw).double())
    want = _port(*[torch.from_numpy(a) for a in (value, loc, aw)])
    _close(got.numpy(), want.numpy(), 2e-6, "float64 sums of bf16 rows")


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="msda_backend"):
        MSDeformAttnModule(torch.Generator().manual_seed(0), 32,
                           len(SHAPES), 2, 4, backend="onehto")


MODEL_SECTION = {"enc_layers": 1, "dec_layers": 2, "hidden_dim": 64,
                 "dim_feedforward": 64, "nheads": 4, "num_queries": 10,
                 "num_depth_bins": 16, "msda_backend": "onehot",
                 "compute_dtype": "float32"}


def test_model_with_onehot_matches_jax():
    """A model built by ``build_monodetr`` from a model section with
    ``msda_backend: onehot`` under float32 against the JAX model from the
    same section (XLA one-hot gathers with bf16 operands), on the JAX
    package's whole-model bf16 statistic |a - b| / (|a| + 1): a bf16 rounding
    of a value row can fall on either side of a tie (logits and boxes max
    0.15; depth 0.9 quantile 0.1, max 0.6)."""
    batch = sample_batch(2, 96, 160)
    jm = jax_build(MODEL_SECTION)
    assert jm.msda_backend == "onehot"
    inputs = [batch[k] for k in MODEL_INPUTS]
    v = jax.jit(lambda *a: jm.init(jax.random.PRNGKey(0), *a))(
        *[x[:1] for x in inputs])
    variables = {"params": _spread_offsets(v["params"],
                                           np.random.default_rng(2)),
                 "frozen": jax.tree_util.tree_map(np.asarray, v["frozen"])}
    out = jax.jit(lambda var, *a: jm.apply(var, *a))(variables, *inputs)
    want = {k: np.asarray(out[k]) for k in HEADS}

    tm = build_monodetr(MODEL_SECTION, device="cpu")
    load_flax_params(tm, variables["params"], variables["frozen"])
    assert all(mod.backend == "onehot" for mod in tm.modules()
               if isinstance(mod, MSDeformAttnModule))
    with torch.no_grad():
        got = tm(*[torch.from_numpy(x) for x in inputs])
    errs = {}
    for k in HEADS:
        assert got[k].dtype == torch.float32, k
        err = np.abs(want[k] - got[k].numpy()) / (np.abs(want[k]) + 1.0)
        errs[k] = {"max": float(err.max()),
                   "q90": float(np.quantile(err, 0.9))}
    print(json.dumps({"onehot_model_vs_jax": errs}))
    for k, e in errs.items():
        if k == "pred_depth":
            assert e["q90"] < 0.1 and e["max"] < 0.6, (k, e)
        else:
            assert e["max"] < 0.15, (k, e)
