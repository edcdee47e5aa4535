"""One train step of the torch port against the JAX package's.

MonoDETR with 1 encoder and 2 decoder layers, d_model 64, 4 heads, 10
queries x 2 Group-DETR groups, 16 depth bins, on ``sample_batch(2, 96,
160)``: the port's ``make_train_step`` against ``jax.value_and_grad`` of the
JAX trainer's loss (forward in training mode, ``criterion``), in float32,
and both again in float64 (JAX under ``jax.enable_x64``).  Both models are
built without dropout (``dropout=0.0``; the JAX depth encoder's fixed 0.1
is set to 0 in a subclass, the port's on its modules), the JAX weights are
carried over by ``load_flax_params``, and the zero-initialised
sampling-offset and attention-weight kernels get small random values
(``_spread_offsets``): on the integer pixel grid the JAX package's jitted
step departs from its own op-by-op result under this suite's
``--xla_cpu_max_isa=AVX2`` (ROADMAP.md, Queue 3).  Tolerance: 2e-4 of each
tensor's largest magnitude (tests/test_criterion_reference_parity.py:226,
tests/test_msda.py:117).  Each comparison prints its largest difference as
a JSON line (``pytest -s``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from monosowa_tpu.models import criterion as jax_crit
from monosowa_tpu.models import depth_predictor as jax_dp
from monosowa_tpu.models.matcher import hungarian_match as jax_match
from monosowa_tpu.models.monodetr import MonoDETR as JaxMonoDETR
from monosowa_tpu.train.trainer import targets_from_batch as jax_targets
from monosowa_tpu_torch.convert import _torch_name
from monosowa_tpu_torch.models import criterion as crit
from monosowa_tpu_torch.models.layers import Dropout
from monosowa_tpu_torch.models.matcher import hungarian_match
from monosowa_tpu_torch.train import optim
from monosowa_tpu_torch.train.sample import sample_batch
from monosowa_tpu_torch.train.trainer import (make_train_step,
                                              targets_from_batch)
from test_torch_train import _one_torch_thread  # noqa: F401 (autouse)
from test_torch_train import (B, H, MODEL_INPUTS, TINY, TOL, W, _close,
                              _flax_paths, _jax_ccfg, _jax_layout,
                              _jax_variables, _port_ccfg, _port_model)


def _no_dropout(model):
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.p = 0.0
    return model


class _JaxDepthEncoderNoDropout(jax_dp.DepthEncoderLayer):
    dropout: float = 0.0


def _step(dtype):
    """One step's losses, matched pairs and gradients from both packages
    on the same batch and weights, computed in ``dtype`` (float32 through
    the port's ``make_train_step``; float64 by its forward, criterion and
    backward, with JAX under ``jax.enable_x64``)."""
    batch = sample_batch(B, H, W)
    f64 = dtype == torch.float64
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(f64):
        mp.setattr(jax_dp, "DepthEncoderLayer", _JaxDepthEncoderNoDropout)
        jm = JaxMonoDETR(msda_backend="xla", dropout=0.0,
                         compute_dtype="float64" if f64 else "float32",
                         **TINY)
        v = _jax_variables(jm, batch)
        jv = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64 if f64 else np.float32), v)
        jbatch = {k: jnp.asarray(a.astype(np.float64) if f64 and
                                 a.dtype == np.float32 else a)
                  for k, a in batch.items()}
        targets = jax_targets(jbatch)
        ccfg = _jax_ccfg()

        def loss_fn(params):
            out = jm.apply({"params": params, "frozen": jv["frozen"]},
                           *[jbatch[k] for k in MODEL_INPUTS], training=True,
                           rngs={"dropout": jax.random.PRNGKey(0)})
            losses = jax_crit.criterion(out, targets, ccfg, training=True)
            matches = [jax_match(o["pred_logits"], o["pred_boxes"],
                                 targets.labels, targets.boxes_3d,
                                 targets.valid, ccfg.matcher,
                                 TINY["group_num"], TINY["num_queries"])
                       for o in [out] + out["aux_outputs"]]
            return losses["loss_total"], (losses, matches)

        (_, (j_losses, j_matches)), j_grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(jv["params"])
        j_losses = {k: float(x) for k, x in j_losses.items()}
        j_losses["grad_norm"] = float(optax.global_norm(j_grads))
        j_grads = jax.tree_util.tree_map(np.asarray, j_grads)

    tm = _no_dropout(_port_model(v, dropout=0.0)).to(dtype)
    tm.train()
    inputs = [torch.from_numpy(batch[k]).to(dtype) for k in MODEL_INPUTS]
    t_targets = targets_from_batch(batch, torch.device("cpu"))
    t_targets = crit.Targets(*[t.to(dtype) if t.is_floating_point() else t
                               for t in t_targets])
    with torch.no_grad():
        out = tm(*inputs)
    t_matches = [hungarian_match(o["pred_logits"], o["pred_boxes"],
                                 t_targets.labels, t_targets.boxes_3d,
                                 t_targets.valid,
                                 num_queries=TINY["num_queries"]).numpy()
                 for o in [out] + out["aux_outputs"]]
    if f64:
        losses = crit.criterion(tm(*inputs), t_targets, _port_ccfg())
        losses["loss_total"].backward()
        t_losses = {k: float(x.detach()) for k, x in losses.items()}
        t_losses["grad_norm"] = float(torch.linalg.vector_norm(torch.stack(
            [p.grad.norm() for p in tm.parameters()])))
    else:
        opt = optim.make_optimizer(tm, 2e-4, 1e-4)
        t_losses = make_train_step(tm, _port_ccfg(), opt)(batch)
    t_grads = {n: p.grad.double().numpy() for n, p in tm.named_parameters()
               if p.grad is not None}
    return dict(model=tm, j_losses=j_losses, t_losses=t_losses,
                j_grads=j_grads, t_grads=t_grads,
                j_matches=[np.asarray(x) for x in j_matches],
                t_matches=t_matches)


@pytest.fixture(scope="module", params=["float32", "float64"])
def step_run(request):
    return _step(getattr(torch, request.param)), request.param


def test_step_matches_same_pairs(step_run):
    run, _ = step_run
    assert len(run["t_matches"]) == len(run["j_matches"]) == 2
    for t, j in zip(run["t_matches"], run["j_matches"]):
        assert t.shape == (B, TINY["num_queries"] * TINY["group_num"])
        np.testing.assert_array_equal(t, j)
        # every valid target matched once in each group
        assert (t >= 0).sum() == B * 3 * TINY["group_num"]


def test_step_loss_dict_matches_jax(step_run):
    run, dtype = step_run
    t, j = run["t_losses"], run["j_losses"]
    assert sorted(t) == sorted(j)
    for k in sorted(j):
        _close(t[k], j[k], TOL, f"step {dtype} {k}")


def test_step_gradients_match_jax(step_run):
    """Every parameter's gradient, leaf by leaf through the weight bridge's
    names, within 2e-4 of the JAX gradient's largest magnitude.  That
    magnitude is floored at 1e-4 of the model's largest gradient: the key
    projections' biases have an exact gradient of 0 (the softmax ignores a
    shift shared by all keys), and both packages leave only rounding noise
    there, about 1e-6 in float32, 5e-9 of the largest gradient.

    In float32 the backbone's gradients are reported, not held: one ReLU
    input of the random-init ResNet-50 lies within float32 rounding of zero
    at these inputs (tools/check_relu_ties.py), the two packages round it
    to opposite sides, and the gradients below it differ by up to 1.7e-2
    of their scale (ROADMAP.md, Queue 3).  In float64 every gradient is
    held, the backbone's included."""
    run, dtype = step_run
    tm, t_grads = run["model"], run["t_grads"]
    j_grads = list(_flax_paths(run["j_grads"]))
    floor = 1e-4 * max(float(np.abs(g).max()) for _, g in j_grads)
    seen = set()
    worst = {"held": (0.0, ""), "backbone, reported": (0.0, "")}
    for path, g in j_grads:
        name = _torch_name(tm, path, "params")
        assert name in t_grads, f"no gradient for {name}"
        got = _jax_layout(t_grads[name], path[-1])
        scale = max(float(np.abs(g).max()), floor)
        rel = float(np.abs(got - g).max()) / scale
        held = dtype == "float64" or not name.startswith("backbone.")
        key = "held" if held else "backbone, reported"
        worst[key] = max(worst[key], (rel, name))
        if held:
            np.testing.assert_allclose(got / scale, g / scale, atol=TOL,
                                       err_msg=name)
        seen.add(name)
    assert seen == set(dict(tm.named_parameters()))
    for key, (rel, name) in worst.items():
        if name:
            print(json.dumps({"port_vs_jax": f"step {dtype} gradients, "
                              f"{key}, worst {name}", "max_rel": rel}))
