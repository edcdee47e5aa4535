"""Two-stage training in the torch port against the JAX package's: the
criterion with ``enc_outputs`` (the encoder match of one group over all S
tokens, the ``_enc`` losses and weights), one ``make_train_step`` with the
JV matcher, the plain ``solve_lap_jv`` on tall problems with ties, and the
top-k selection of the proposals on tied scores.

Model sizes as in tests/test_torch_train_step.py (1 encoder and 2 decoder
layers, d_model 64, 10 queries x 2 groups, 96x160 images: S = 321 tokens),
without dropout.  Tolerances: 2e-4 of each tensor's largest magnitude for
losses and gradients (tests/test_torch_train_step.py's bar, with its rule
for the float32 backbone's gradients); assignments equal, assignment for
assignment; JV's total cost at scipy's optimum within 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from monosowa_tpu.models import criterion as jax_crit
from monosowa_tpu.models import depth_predictor as jax_dp
from monosowa_tpu.models.matcher import MatcherConfig as JaxMatcherConfig
from monosowa_tpu.models.matcher import hungarian_match as jax_match
from monosowa_tpu.models.monodetr import MonoDETR as JaxMonoDETR
from monosowa_tpu.ops.lap import solve_lap_jv as jax_solve_jv
from monosowa_tpu.train.trainer import targets_from_batch as jax_targets
from monosowa_tpu_torch.convert import _torch_name, load_flax_params
from monosowa_tpu_torch.models import criterion as crit
from monosowa_tpu_torch.models.matcher import MatcherConfig, hungarian_match
from monosowa_tpu_torch.models.monodetr import MonoDETR, top_k_indices
from monosowa_tpu_torch.ops import lap
from monosowa_tpu_torch.train import optim
from monosowa_tpu_torch.train.sample import sample_batch
from monosowa_tpu_torch.train.trainer import (make_train_step,
                                              targets_from_batch)
from test_torch_detector_variants import (TINY, TOL,
                                          _JaxDepthEncoderNoDropout,
                                          jax_variables, no_dropout)
from test_torch_train import _one_torch_thread  # noqa: F401 (autouse)
from test_torch_train import (B, H, MODEL_INPUTS, W, _close, _flax_paths,
                              _jax_layout, _random_outputs)

S_TOK = 321


def _ccfgs(backend="jv"):
    kw = dict(group_num=TINY["group_num"], num_queries=TINY["num_queries"],
              num_classes=3)
    return (jax_crit.CriterionConfig(
                matcher=JaxMatcherConfig(backend=backend), **kw),
            crit.CriterionConfig(matcher=MatcherConfig(backend=backend), **kw))


# ---------------------------------------------------------------------------
# the criterion with enc_outputs, on the same outputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["host", "jv"])
def test_criterion_with_enc_outputs_matches_jax(backend):
    """The loss dict, ``_enc`` keys and ``loss_total`` included, and the
    encoder match itself (one group of S = 321 tokens)."""
    rng = np.random.default_rng(11)
    out = _random_outputs(rng, TINY["num_queries"] * TINY["group_num"])
    out["enc_outputs"] = {
        "pred_logits": rng.normal(size=(B, S_TOK, 3)).astype(np.float32),
        "pred_boxes": (1 / (1 + np.exp(-rng.normal(size=(B, S_TOK, 6)))))
        .astype(np.float32)}
    batch = sample_batch(B, H, W, seed=3)
    jcfg, tcfg = _ccfgs(backend)
    jt = jax_targets({k: jnp.asarray(v) for k, v in batch.items()})
    want = jax_crit.criterion(jax.tree_util.tree_map(jnp.asarray, out), jt,
                              jcfg)
    tt = targets_from_batch(batch, torch.device("cpu"))
    got = crit.criterion(jax.tree_util.tree_map(torch.from_numpy, out), tt,
                         tcfg)
    assert sorted(got) == sorted(want)
    assert {"loss_ce_enc", "loss_center_enc", "loss_bbox_enc",
            "loss_giou_enc"} <= set(got)
    for k in sorted(want):
        _close(float(got[k]), float(want[k]), TOL, f"enc criterion {k}")
    enc = out["enc_outputs"]
    j_idx = np.asarray(jax_match(
        jnp.asarray(enc["pred_logits"]), jnp.asarray(enc["pred_boxes"]),
        jt.labels, jt.boxes_3d, jt.valid, jcfg.matcher, 1, S_TOK))
    t_idx = hungarian_match(torch.from_numpy(enc["pred_logits"]),
                            torch.from_numpy(enc["pred_boxes"]), tt.labels,
                            tt.boxes_3d, tt.valid, tcfg.matcher, S_TOK)
    np.testing.assert_array_equal(t_idx.numpy(), j_idx)
    assert (t_idx >= 0).sum(1).tolist() == [3] * B


def test_criterion_ignores_dn_outputs():
    """``dn_outputs`` add nothing to the loss dict, as in the JAX
    criterion (``dn_loss`` supervises them)."""
    rng = np.random.default_rng(5)
    out = jax.tree_util.tree_map(torch.from_numpy, _random_outputs(rng, 20))
    tt = targets_from_batch(sample_batch(B, H, W), torch.device("cpu"))
    _, tcfg = _ccfgs("host")
    plain = crit.criterion(out, tt, tcfg)
    dn_out = [{"pred_logits": torch.zeros(B, 12, 3),
               "pred_boxes": torch.full((B, 12, 6), 0.5)}]
    with_dn = crit.criterion({**out, "dn_outputs": dn_out}, tt, tcfg)
    assert sorted(with_dn) == sorted(plain)
    assert float(with_dn["loss_total"]) == float(plain["loss_total"])


# ---------------------------------------------------------------------------
# one two_stage train step
# ---------------------------------------------------------------------------

def _two_stage_step(dtype):
    batch = sample_batch(B, H, W)
    f64 = dtype == torch.float64
    jcfg, tcfg = _ccfgs("jv")
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(f64):
        mp.setattr(jax_dp, "DepthEncoderLayer", _JaxDepthEncoderNoDropout)
        jm = JaxMonoDETR(msda_backend="xla", dropout=0.0, two_stage=True,
                         compute_dtype="float64" if f64 else "float32",
                         **TINY)
        v = jax_variables(jm, [batch[k] for k in MODEL_INPUTS])
        jv = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64 if f64 else np.float32), v)
        jbatch = {k: jnp.asarray(a.astype(np.float64) if f64 and
                                 a.dtype == np.float32 else a)
                  for k, a in batch.items()}
        targets = jax_targets(jbatch)

        def loss_fn(params):
            out = jm.apply({"params": params, "frozen": jv["frozen"]},
                           *[jbatch[k] for k in MODEL_INPUTS], training=True,
                           rngs={"dropout": jax.random.PRNGKey(0)})
            losses = jax_crit.criterion(out, targets, jcfg, training=True)
            enc = out["enc_outputs"]
            match = jax_match(enc["pred_logits"], enc["pred_boxes"],
                              targets.labels, targets.boxes_3d,
                              targets.valid, jcfg.matcher, 1, S_TOK)
            return losses["loss_total"], (losses, match)

        (_, (j_losses, j_match)), j_grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(jv["params"])
        j_losses = {k: float(x) for k, x in j_losses.items()}
        j_losses["grad_norm"] = float(optax.global_norm(j_grads))
        j_grads = jax.tree_util.tree_map(np.asarray, j_grads)

    tm = no_dropout(MonoDETR(device="cpu", dropout=0.0, two_stage=True,
                             **TINY))
    load_flax_params(tm, v["params"], v["frozen"])
    tm = tm.to(dtype)
    tm.train()
    inputs = [torch.from_numpy(batch[k]).to(dtype) for k in MODEL_INPUTS]
    t_targets = targets_from_batch(batch, torch.device("cpu"))
    t_targets = crit.Targets(*[t.to(dtype) if t.is_floating_point() else t
                               for t in t_targets])
    with torch.no_grad():
        enc = tm(*inputs)["enc_outputs"]
    t_match = hungarian_match(enc["pred_logits"], enc["pred_boxes"],
                              t_targets.labels, t_targets.boxes_3d,
                              t_targets.valid, tcfg.matcher, S_TOK).numpy()
    if f64:
        losses = crit.criterion(tm(*inputs), t_targets, tcfg)
        losses["loss_total"].backward()
        t_losses = {k: float(x.detach()) for k, x in losses.items()}
        t_losses["grad_norm"] = float(torch.linalg.vector_norm(torch.stack(
            [p.grad.norm() for p in tm.parameters()])))
    else:
        opt = optim.make_optimizer(tm, 2e-4, 1e-4)
        t_losses = make_train_step(tm, tcfg, opt)(batch)
    t_grads = {n: p.grad.double().numpy() for n, p in tm.named_parameters()
               if p.grad is not None}
    return dict(model=tm, j_losses=j_losses, t_losses=t_losses,
                j_grads=j_grads, t_grads=t_grads,
                j_match=np.asarray(j_match), t_match=t_match)


@pytest.fixture(scope="module", params=["float32", "float64"])
def step_run(request):
    return _two_stage_step(getattr(torch, request.param)), request.param


def test_two_stage_step_loss_dict_matches_jax(step_run):
    run, dtype = step_run
    t, j = run["t_losses"], run["j_losses"]
    assert sorted(t) == sorted(j)
    assert "loss_giou_enc" in t
    for k in sorted(j):
        _close(t[k], j[k], TOL, f"two_stage step {dtype} {k}")


def test_two_stage_step_encoder_match_equals_jax(step_run):
    run, _ = step_run
    assert run["t_match"].shape == (B, S_TOK)
    np.testing.assert_array_equal(run["t_match"], run["j_match"])


def test_two_stage_step_gradients_match_jax(step_run):
    """Every parameter's gradient through the weight bridge's names, the
    encoder-proposal heads included, within 2e-4 of the JAX gradient's
    largest magnitude floored at 1e-4 of the model's largest; in float32
    the backbone's reported, not held (tests/test_torch_train_step.py says
    why), in float64 every one held."""
    run, dtype = step_run
    tm, t_grads = run["model"], run["t_grads"]
    j_grads = list(_flax_paths(run["j_grads"]))
    floor = 1e-4 * max(float(np.abs(g).max()) for _, g in j_grads)
    seen = set()
    for path, g in j_grads:
        name = _torch_name(tm, path, "params")
        assert name in t_grads, f"no gradient for {name}"
        got = _jax_layout(t_grads[name], path[-1])
        scale = max(float(np.abs(g).max()), floor)
        if dtype == "float64" or not name.startswith("backbone."):
            np.testing.assert_allclose(got / scale, g / scale, atol=TOL,
                                       err_msg=name)
        seen.add(name)
    assert seen == set(dict(tm.named_parameters()))
    assert {"enc_class.weight", "pos_trans.weight",
            "enc_bbox.layers.2.bias"} <= seen


# ---------------------------------------------------------------------------
# the tall assignment problems and the top-k on ties
# ---------------------------------------------------------------------------

def _tall_problems(q=2000, m=50):
    """Four q x m problems as the encoder match makes them: n_valid 0, 17,
    50 and 50, padding columns at the matcher's 1e6; ties from duplicated
    columns and rows, integer costs, and a constant block."""
    rng = np.random.default_rng(21)
    cost = (rng.normal(size=(4, q, m)) * 10.0).astype(np.float32)
    n_valid = np.array([0, 17, m, m])
    cost[1, :, 5] = cost[1, :, 2]
    cost[1, 900] = cost[1, 4]
    cost[2] = np.round(cost[2])
    cost[3, :100] = 1.0
    for k in range(4):
        cost[k, :, n_valid[k]:] = 1e6
    return cost, n_valid


def test_plain_jv_on_tall_problems_matches_jax_and_scipy():
    cost, n_valid = _tall_problems()
    want = np.stack([np.asarray(jax_solve_jv(jnp.asarray(c), jnp.int32(n)))
                     for c, n in zip(cost, n_valid)])
    got = lap.solve_lap_jv(torch.from_numpy(cost), torch.from_numpy(n_valid))
    np.testing.assert_array_equal(got.numpy(), want)
    via_wrapper = lap.lap_jv(torch.from_numpy(cost),
                             torch.from_numpy(n_valid))
    np.testing.assert_array_equal(via_wrapper.numpy(), want)
    for k, (c, n) in enumerate(zip(cost.astype(np.float64), n_valid)):
        a = got[k].numpy()
        assert int((a >= 0).sum()) == n
        if n:
            rows, cols = linear_sum_assignment(c[:, :n])
            opt = c[rows, cols].sum()
            val = c[a >= 0, a[a >= 0]].sum()
            assert abs(val - opt) <= 1e-5 + 1e-6 * abs(opt), (k, val, opt)


def test_tall_problems_take_the_tall_form():
    """The wrapper's choice among the hand-written forms (``jv_plan``, from
    the shape alone): the decoder's 50 x 50 problem takes the warp form;
    the encoder match of 10,200 x 50 is past the warp form's 512 rows and
    takes a cluster of 16 blocks, each holding 638 objects' costs in its
    shared memory; the tall form still takes it where asked, its state of
    20 bytes an object in the block's shared memory up to about 11,600
    rows."""
    assert lap.jv_plan(50, 50).form == "warp"
    assert "warp" not in lap.jv_forms(10200, 50)
    plan = lap.jv_plan(10200, 50)
    assert (plan.form, plan.cluster) == ("cluster", 16)
    assert plan.smem_bytes <= lap.SMEM_LIMIT
    assert lap.jv_plan(10200, 50, "tall").state_in_smem
    assert lap.jv_tall_smem_bytes(10200, 50, True) <= lap.SMEM_LIMIT
    assert lap.jv_tall_smem_bytes(12000, 50, True) > lap.SMEM_LIMIT
    assert lap.jv_tall_smem_bytes(12000, 50, False) < 1024


@pytest.mark.parametrize("k", [1, 7, 20, 321])
def test_top_k_on_ties_matches_jax(k):
    rng = np.random.default_rng(k)
    scores = np.round(rng.normal(size=(B, S_TOK)), 1).astype(np.float32)
    scores[0, 100:140] = scores[0, 3]
    scores[1] = np.where(rng.random(S_TOK) < 0.5, 0.25, scores[1])
    _, want = jax.lax.top_k(jnp.asarray(scores), k)
    got = top_k_indices(torch.from_numpy(scores), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
