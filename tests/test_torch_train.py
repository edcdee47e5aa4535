"""The torch port's training pieces against the JAX package's: matcher,
criterion, the Group-DETR fold and dropout, AdamW and its decay mask, the
LR schedule, checkpoints, and learning over a few steps
(tests/test_torch_train_step.py holds one whole train step).

Sizes: MonoDETR with 1 encoder and 2 decoder layers, d_model 64, 4 heads,
10 queries x 2 Group-DETR groups, 16 depth bins; targets from
``sample_batch``.  Tolerances: 2e-4 of each tensor's largest magnitude for
losses and gradients (tests/test_criterion_reference_parity.py:226,
tests/test_msda.py:117); 1e-6 for AdamW on identical gradients.  Each
comparison prints its largest difference as a JSON line (``pytest -s``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__
from monosowa_tpu.models import criterion as jax_crit
from monosowa_tpu.models.matcher import MatcherConfig as JaxMatcherConfig
from monosowa_tpu.models.matcher import hungarian_match as jax_match
from monosowa_tpu.models.monodetr import MonoDETR as JaxMonoDETR
from monosowa_tpu.models.transformer import \
    DepthAwareDecoderLayer as JaxDecoderLayer
from monosowa_tpu.train import optim as jax_optim
from monosowa_tpu.train.trainer import targets_from_batch as jax_targets
from monosowa_tpu_torch.convert import (_to_torch_layout, _torch_name,
                                        load_flax_params)
from monosowa_tpu_torch.models import criterion as crit
from monosowa_tpu_torch.models.layers import Dropout
from monosowa_tpu_torch.models.matcher import hungarian_match
from monosowa_tpu_torch.models.monodetr import MonoDETR
from monosowa_tpu_torch.models.transformer import DepthAwareDecoderLayer
from monosowa_tpu_torch.train import checkpoint, optim
from monosowa_tpu_torch.train.sample import sample_batch
from monosowa_tpu_torch.train.trainer import (make_eval_step,
                                              make_train_step,
                                              targets_from_batch)
from test_torch_slice import _spread_offsets

TINY = dict(enc_layers=1, dec_layers=2, group_num=2, d_model=64, d_ffn=64,
            nheads=4, num_queries=10, num_depth_bins=16)
B, H, W = 2, 96, 160
TOL = 2e-4
MODEL_INPUTS = ("image", "calib", "img_size")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch CPU thread in this module (and in those that import this
    fixture): the suite runs six worker processes at once, and torch's
    default of one thread per core then oversubscribes the machine (a 3 s
    train-step test took 125 s in the full suite)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol, what):
    """Asserts agreement within ``tol`` of want's largest magnitude and
    prints the largest difference relative to it."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-12)
    rel = float(np.abs(got - want).max()) / scale
    print(json.dumps({"port_vs_jax": what, "max_rel": rel}))
    np.testing.assert_allclose(got / scale, want / scale, atol=tol,
                               err_msg=what)


def _jax_ccfg():
    return jax_crit.CriterionConfig(
        group_num=TINY["group_num"], num_queries=TINY["num_queries"],
        num_classes=3, matcher=JaxMatcherConfig(backend="jv"))


def _port_ccfg():
    return crit.CriterionConfig(group_num=TINY["group_num"],
                                num_queries=TINY["num_queries"],
                                num_classes=3)


def _jax_variables(jm, batch):
    v = jax.jit(lambda *a: jm.init(jax.random.PRNGKey(0), *a))(
        *[batch[k][:1] for k in MODEL_INPUTS])
    return {"params": _spread_offsets(v["params"], np.random.default_rng(1)),
            "frozen": jax.tree_util.tree_map(np.asarray, v["frozen"])}


def _port_model(v, **kw):
    tm = MonoDETR(device="cpu", **{**TINY, **kw})
    return load_flax_params(tm, v["params"], v["frozen"])


def _flax_paths(tree, path=()):
    for k, val in tree.items():
        if isinstance(val, dict):
            yield from _flax_paths(val, path + (k,))
        else:
            yield path + (k,), val


def _jax_layout(arr, flax_leaf):
    """A port gradient in the Flax layout of its parameter."""
    if flax_leaf == "kernel" and arr.ndim == 2:
        return arr.T
    if flax_leaf == "kernel" and arr.ndim == 4:
        return arr.transpose(2, 3, 1, 0)          # OIHW -> HWIO
    return arr


# ---------------------------------------------------------------------------
# matcher and criterion on the same outputs
# ---------------------------------------------------------------------------

def _random_outputs(rng, q, n_aux=1, hw=(6, 10), nbins=16):
    def layer():
        return {"pred_logits": rng.normal(size=(B, q, 3)),
                "pred_boxes": 1 / (1 + np.exp(-rng.normal(size=(B, q, 6)))),
                "pred_3d_dim": rng.normal(0, 0.3, (B, q, 3)),
                "pred_angle": rng.normal(size=(B, q, 24)),
                "pred_depth": np.stack(
                    [rng.uniform(5, 50, (B, q)),
                     rng.normal(0, 0.5, (B, q))], -1)}

    out = layer()
    out["aux_outputs"] = [layer() for _ in range(n_aux)]
    out["pred_depth_map_logits"] = rng.normal(size=(B,) + hw + (nbins + 1,))
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), out)


def _batch_with_edges(seed):
    """sample_batch targets plus boxes that cross the image's left or top
    edge (the DDN paint's hold-point, criterion.py:201-206) and an invalid
    target between valid ones."""
    batch = sample_batch(B, H, W, seed=seed)
    batch["boxes"][0, 0, :2] = (0.02, 0.5)
    batch["boxes"][1, 1, :2] = (0.5, 0.01)
    batch["mask_2d"][1, 0] = False
    return batch


@pytest.mark.parametrize("seed", [0, 1])
def test_matcher_matches_jax_jv(seed):
    rng = np.random.default_rng(seed)
    q = TINY["num_queries"] * TINY["group_num"]
    out = _random_outputs(rng, q)
    batch = _batch_with_edges(seed)
    jt = jax_targets({k: jnp.asarray(a) for k, a in batch.items()})
    tt = targets_from_batch(batch, torch.device("cpu"))
    want = np.asarray(jax_match(
        jnp.asarray(out["pred_logits"]), jnp.asarray(out["pred_boxes"]),
        jt.labels, jt.boxes_3d, jt.valid, JaxMatcherConfig(backend="jv"),
        TINY["group_num"], TINY["num_queries"]))
    got = hungarian_match(torch.from_numpy(out["pred_logits"]),
                          torch.from_numpy(out["pred_boxes"]), tt.labels,
                          tt.boxes_3d, tt.valid,
                          num_queries=TINY["num_queries"]).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("training", [True, False])
def test_criterion_matches_jax(training):
    rng = np.random.default_rng(3)
    q = TINY["num_queries"] * (TINY["group_num"] if training else 1)
    out = _random_outputs(rng, q)
    batch = _batch_with_edges(3)
    want = jax_crit.criterion(
        jax.tree_util.tree_map(jnp.asarray, out),
        jax_targets({k: jnp.asarray(a) for k, a in batch.items()}),
        _jax_ccfg(), training=training)
    got = crit.criterion(
        jax.tree_util.tree_map(torch.from_numpy, out),
        targets_from_batch(batch, torch.device("cpu")), _port_ccfg(),
        training=training)
    assert sorted(got) == sorted(want)
    for k in sorted(want):
        _close(float(got[k]), float(want[k]), TOL,
               f"criterion training={training} {k}")


def test_criterion_gradients_match_jax():
    """d loss_total / d outputs, the criterion's own backward."""
    rng = np.random.default_rng(4)
    out = _random_outputs(rng, TINY["num_queries"] * TINY["group_num"])
    batch = _batch_with_edges(4)
    jt = jax_targets({k: jnp.asarray(a) for k, a in batch.items()})
    want = jax.grad(lambda o: jax_crit.criterion(
        o, jt, _jax_ccfg())["loss_total"])(
        jax.tree_util.tree_map(jnp.asarray, out))
    t_out = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(a).requires_grad_(), out)
    crit.criterion(t_out, targets_from_batch(batch, torch.device("cpu")),
                   _port_ccfg())["loss_total"].backward()
    for (path, w), t in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree_util.tree_leaves(t_out)):
        _close(t.grad.numpy(), w, TOL,
               "criterion d" + jax.tree_util.keystr(path))


def test_criterion_config_from_yaml_matches_jax():
    """The shipped model yaml with two weights changed: every field of the
    port's config as the JAX package reads it."""
    import dataclasses
    import os

    from monosowa_tpu.train.trainer import \
        criterion_config_from_yaml as jax_from_yaml
    from monosowa_tpu_torch.config import load_yaml
    from monosowa_tpu_torch.train.trainer import criterion_config_from_yaml

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "monodetr_kitti.yaml")
    mcfg = dict(load_yaml(path)["model"], cls_loss_coef=3,
                depth_map_loss_coef=0.5)
    want = jax_from_yaml(JaxMonoDETR(**TINY), mcfg)
    got = criterion_config_from_yaml(MonoDETR(device="cpu", **TINY), mcfg)
    for field in dataclasses.fields(got):
        w, g = getattr(want, field.name), getattr(got, field.name)
        if field.name == "matcher":
            w = {f.name: getattr(w, f.name) for f in dataclasses.fields(g)}
            g = dataclasses.asdict(g)
        assert g == w, field.name
    assert got.w_cls == 3.0 and got.group_num == TINY["group_num"]


def test_criterion_rejects_what_the_port_lacks():
    """DN-DETR outputs are ignored, as in the JAX criterion (``dn_loss``
    supervises them; tests/test_torch_two_stage_train.py holds the
    ``enc_outputs`` losses).  The TFL and mask losses are ported: without
    a car payload they add nothing, as in the JAX package
    (tests/test_torch_add_data.py holds them with one)."""
    out = jax.tree_util.tree_map(
        torch.from_numpy, _random_outputs(np.random.default_rng(5), 20))
    targets = targets_from_batch(sample_batch(B, H, W), torch.device("cpu"))
    with_flags = crit.criterion(out, targets, crit.CriterionConfig(
        use_tfl=True, use_mask_loss=True, group_num=2, num_queries=10))
    plain = crit.criterion(out, targets, crit.CriterionConfig(
        group_num=2, num_queries=10))
    assert sorted(with_flags) == sorted(plain)
    assert float(with_flags["loss_total"]) == float(plain["loss_total"])
    dn_outputs = [{"pred_logits": torch.ones(B, 6, 3),
                   "pred_boxes": torch.full((B, 6, 6), 0.5)}] * 2
    ccfg = crit.CriterionConfig(group_num=2, num_queries=10)
    with_dn = crit.criterion({**out, "dn_outputs": dn_outputs}, targets,
                             ccfg)
    assert sorted(with_dn) == sorted(plain)
    assert float(with_dn["loss_total"]) == float(plain["loss_total"])


# ---------------------------------------------------------------------------
# Group-DETR fold and dropout
# ---------------------------------------------------------------------------

def test_decoder_layer_group_fold_matches_jax():
    """The decoder layer in training mode with 2 groups against the JAX
    layer (training=True, no dropout): each group attends only to itself."""
    rng = np.random.default_rng(6)
    # no 1-row level: the JAX package's quad gather needs two rows
    # (ROADMAP.md, Queue 3)
    shapes = ((6, 10), (3, 5), (2, 3), (2, 2))
    s = sum(h * w for h, w in shapes)
    d, g, nq = 32, 2, 5
    tgt = rng.normal(size=(B, g * nq, d)).astype(np.float32)
    pos = rng.normal(size=(B, g * nq, d)).astype(np.float32)
    ref = rng.uniform(0.1, 0.9, (B, g * nq, len(shapes), 2)
                      ).astype(np.float32)
    src = rng.normal(size=(B, s, d)).astype(np.float32)
    dep = rng.normal(size=(B, 12, d)).astype(np.float32)
    args = (tgt, pos, ref, src, shapes, dep)
    jl = JaxDecoderLayer(d_model=d, d_ffn=d, dropout=0.0, n_heads=4,
                         group_num=g, msda_backend="xla")
    params = jl.init(jax.random.PRNGKey(0), *args, True, True)["params"]
    params = _spread_offsets(params, rng)
    want = np.asarray(jl.apply({"params": params}, *args, True, True))

    tl = DepthAwareDecoderLayer(torch.Generator().manual_seed(0), d, d,
                                len(shapes), 4, 4, dropout=0.0, group_num=g)
    load_flax_params(tl, params)
    tl.train()
    t_args = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
              for a in args]
    with torch.no_grad():
        got = tl(*t_args).numpy()
        # group 1's queries do not reach group 0's output
        t_args[0] = t_args[0].clone()
        t_args[0][:, nq:] += 1.0
        moved = tl(*t_args).numpy()
        tl.eval()
        ungrouped = tl(*[torch.from_numpy(a) if isinstance(a, np.ndarray)
                         else a for a in args]).numpy()
    _close(got, want, TOL, "decoder layer, 2 groups folded")
    np.testing.assert_array_equal(moved[:, :nq], got[:, :nq])
    assert np.abs(ungrouped - got).max() > 1e-3      # eval: one group


def test_dropout_module():
    x = torch.ones(4000)
    drop = Dropout(0.25)
    drop.generator = torch.Generator().manual_seed(0)
    y = drop(x)
    kept = y != 0
    assert 0.70 < float(kept.float().mean()) < 0.80
    np.testing.assert_allclose(y[kept].numpy(), 1 / 0.75, rtol=1e-6)
    drop.eval()
    assert drop(x) is x


def test_model_train_and_eval_modes():
    """train(): all groups of queries and dropout drawn from the given
    generator; eval(): the first group, no dropout."""
    tm = MonoDETR(device="cpu", **TINY)
    batch = sample_batch(1, 64, 96)
    args = [torch.from_numpy(batch[k]) for k in MODEL_INPUTS]
    tm.train()
    with torch.no_grad():
        a = tm(*args, generator=torch.Generator().manual_seed(1))
        b = tm(*args, generator=torch.Generator().manual_seed(1))
        c = tm(*args, generator=torch.Generator().manual_seed(2))
        tm.eval()
        e1 = tm(*args, generator=torch.Generator().manual_seed(1))
        e2 = tm(*args)
    nq = TINY["num_queries"]
    assert a["pred_logits"].shape == (1, nq * TINY["group_num"], 3)
    assert e1["pred_logits"].shape == (1, nq, 3)
    torch.testing.assert_close(a["pred_logits"], b["pred_logits"],
                               rtol=0, atol=0)
    assert (a["pred_logits"] - c["pred_logits"]).abs().max() > 1e-4
    torch.testing.assert_close(e1["pred_logits"], e2["pred_logits"],
                               rtol=0, atol=0)
    # eval after a train step: make_eval_step puts the model in eval mode
    tm.train()
    dets = make_eval_step(tm, topk=5)(batch)
    assert dets.shape == (1, 5, 37) and not tm.training


# ---------------------------------------------------------------------------
# optimizer, schedule, checkpoints, learning
# ---------------------------------------------------------------------------

def test_weight_decay_mask_matches_jax_full_width():
    """The decay mask of the full-width detector, leaf for leaf against
    ``optim.weight_decay_mask`` on the Flax tree."""
    jm = JaxMonoDETR(compute_dtype="float32")
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)),
                        jnp.zeros((1, 3, 4)), jnp.zeros((1, 2))))["params"]
    want = jax_optim.weight_decay_mask(jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes))
    tm = MonoDETR(device="cpu")
    got = optim.weight_decay_mask(tm)
    flat = {_torch_name(tm, path, "params"): bool(m)
            for path, m in _flax_paths(want)}
    assert flat == got
    assert not got["level_embed"] and not got["query_embed"]
    assert not got["depth_predictor.depth_pos_embed"]
    assert got["backbone.conv1.weight"] and not got["input_norm0.weight"]


def test_adamw_matches_optax_on_identical_gradients():
    """Three AdamW steps from the same parameters and gradients, through a
    schedule boundary, with the decay mask: within 1e-6.  The depth
    predictor's tree holds every kind of leaf the mask tells apart: dense
    and convolution kernels, biases, norm scales and a raw table."""
    from monosowa_tpu.models.depth_predictor import DepthPredictor as JaxDP
    from monosowa_tpu_torch.models.depth_predictor import DepthPredictor

    d = TINY["d_model"]
    feats = [np.zeros((1, h, w, d), np.float32)
             for h, w in ((4, 6), (2, 3), (1, 2))]
    pos16 = np.zeros((2, 3, d), np.float32)
    params = JaxDP(d_model=d, num_depth_bins=16).init(
        jax.random.PRNGKey(0), feats, pos16)["params"]
    tm = DepthPredictor(torch.Generator().manual_seed(0), d_model=d,
                        num_depth_bins=16)
    load_flax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    tx = jax_optim.make_optimizer(base_lr=1e-3, weight_decay=0.05,
                                  steps_per_epoch=1, decay_epochs=(2,))
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(j_params)
    update = jax.jit(tx.update)
    opt = optim.make_optimizer(tm, 1e-3, 0.05)
    sched = optim.make_lr_schedule(1e-3, 1, decay_epochs=(2,))
    named = dict(tm.named_parameters())
    rng = np.random.default_rng(8)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda a: rng.normal(size=a.shape).astype(np.float32), j_params)
        for path, g in _flax_paths(grads):
            named[_torch_name(tm, path, "params")].grad = torch.from_numpy(
                np.ascontiguousarray(_to_torch_layout(g, path[-1])))
        lr = sched(optim.optimizer_step(opt))
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        updates, state = update(jax.tree_util.tree_map(jnp.asarray, grads),
                                state, j_params)
        j_params = optax.apply_updates(j_params, updates)
    assert optim.optimizer_step(opt) == 3
    worst = 0.0
    for path, want in _flax_paths(jax.tree_util.tree_map(np.asarray,
                                                         j_params)):
        got = _jax_layout(named[_torch_name(tm, path, "params")]
                          .detach().numpy(), path[-1])
        worst = max(worst, float(np.abs(got - want).max()))
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    print(json.dumps({"port_vs_jax": "AdamW vs optax.adamw, 3 steps",
                      "max_abs": worst}))


@pytest.mark.parametrize("warmup", [0, 2])
def test_lr_schedule_matches_jax(warmup):
    want = jax_optim.make_lr_schedule(2e-4, steps_per_epoch=10,
                                      decay_epochs=(5, 8),
                                      warmup_epochs=warmup)
    got = optim.make_lr_schedule(2e-4, steps_per_epoch=10,
                                 decay_epochs=(5, 8), warmup_epochs=warmup)
    # optax evaluates the cosine warmup in float32
    for step in (0, 1, 5, 19, 20, 49, 50, 55, 79, 80, 85, 200):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-5)
    if not warmup:   # the values of tests/test_train_step.py:61
        assert got(0) == pytest.approx(2e-4)
        assert got(55) == pytest.approx(2e-5, rel=1e-5)
        assert got(85) == pytest.approx(2e-6, rel=1e-5)


def test_checkpoint_round_trip(tmp_path):
    batch = sample_batch(B, 64, 96)
    models, steps = [], []
    for _ in range(2):
        tm = MonoDETR(device="cpu", **TINY)
        opt = optim.make_optimizer(tm, 1e-3)
        models.append((tm, opt))
        steps.append(make_train_step(tm, None, opt))
    steps[0](batch, torch.Generator().manual_seed(0))
    path = checkpoint.save_checkpoint(str(tmp_path), *models[0], step=1,
                                      epoch=3, best_ap=0.5)
    checkpoint.save_checkpoint(str(tmp_path), *models[0], step=1, epoch=12)
    assert path.endswith("checkpoint_epoch_3")
    assert checkpoint.list_checkpoints(str(tmp_path)) == [
        str(tmp_path / "checkpoint_epoch_3"),
        str(tmp_path / "checkpoint_epoch_12")]
    assert checkpoint.latest_checkpoint(str(tmp_path)).endswith("_12")
    assert checkpoint.latest_checkpoint(str(tmp_path / "none")) is None
    meta = checkpoint.restore_checkpoint(path, *models[1])
    assert meta == {"step": 1, "epoch": 3, "best_ap": 0.5}
    assert optim.optimizer_step(models[1][1]) == 1
    for (k, a), b in zip(models[0][0].state_dict().items(),
                         models[1][0].state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    # the next step from either copy is the same step
    l0 = steps[0](batch, torch.Generator().manual_seed(1))
    l1 = steps[1](batch, torch.Generator().manual_seed(1))
    assert l0 == l1


def test_train_step_decreases_loss():
    """tests/test_train_step.py:26 for the port: 8 steps on a fixed batch
    at lr 1e-3, one group, dropout on."""
    torch.manual_seed(0)
    tm = MonoDETR(device="cpu", **{**TINY, "group_num": 1})
    step = make_train_step(tm, None, optim.make_optimizer(tm, 1e-3),
                           optim.make_lr_schedule(1e-3, 100))
    batch = sample_batch(2, 96, 160)
    gen = torch.Generator().manual_seed(0)
    first = step(batch, gen)
    for _ in range(7):
        losses = step(batch, gen)
    assert np.isfinite(losses["loss_total"])
    assert losses["loss_total"] < first["loss_total"]
    assert losses["grad_norm"] > 0


def test_sample_batch_matches_graft_entry():
    for args in ((2, 96, 160), (3, 64, 96, 5, 7)):
        want = __graft_entry__._sample_batch(*args)
        got = sample_batch(*args)
        assert sorted(got) == sorted(want)
        for k in want:
            w = np.asarray(want[k])
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
