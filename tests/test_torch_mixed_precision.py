"""The port's mixed-precision policy against the JAX package's.

``compute_dtype`` (JAX ``models/layers.py`` ``resolve_dtype``,
``MonoDETR.compute_dtype``, ``build_monodetr``): "auto" is bfloat16 on the
accelerator and float32 on the CPU; under "bfloat16" the backbone, the input
projections, every policy dense layer and the attention operands compute in
bf16, while the params, norms, softmax logits, sampling offsets and weights
and the heads stay float32 (the JAX package's
tests/test_mixed_precision.py:1-9).

MonoDETR at the widths of tests/test_torch_slice.py (d_model 64, 4 heads, 1
encoder and 2 decoder layers, one group of 10 queries, 16 depth bins) on
``sample_batch(2, 96, 160)``; the JAX weights are carried over by
``load_flax_params``, with the zero-initialised sampling-offset kernels
spread (tests/test_torch_slice.py says why).  Whole-model bf16 comparisons
use the JAX package's own bars (tests/test_mixed_precision.py:40-51): bf16
rounds in other places in XLA:CPU and in torch, so two bf16 models agree
only as closely as each agrees with float32.  Each comparison prints its
numbers as a JSON line (``pytest -s``).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from flax import linen as fnn
from monosowa_tpu.models import criterion as jax_crit
from monosowa_tpu.models import depth_predictor as jax_dp
from monosowa_tpu.models.layers import resolve_dtype as jax_resolve_dtype
from monosowa_tpu.models.matcher import MatcherConfig as JaxMatcherConfig
from monosowa_tpu.models.monodetr import MonoDETR as JaxMonoDETR
from monosowa_tpu.models.monodetr import build_monodetr as jax_build
from monosowa_tpu.train.trainer import targets_from_batch as jax_targets
from monosowa_tpu_torch.convert import AUTO_NAMES, load_flax_params
from monosowa_tpu_torch.models import criterion as crit
from monosowa_tpu_torch.models.layers import (COMPUTE_DTYPES, Dropout,
                                              resolve_dtype)
from monosowa_tpu_torch.models.monodetr import MonoDETR, build_monodetr
from monosowa_tpu_torch.train import optim
from monosowa_tpu_torch.train.sample import sample_batch
from monosowa_tpu_torch.train.trainer import make_train_step
from test_torch_slice import TINY, _spread_offsets
from test_torch_train import _one_torch_thread  # noqa: F401 (autouse)

B, H, W = 2, 96, 160
MODEL_INPUTS = ("image", "calib", "img_size")
HEADS = ("pred_logits", "pred_boxes", "pred_depth")
CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# (a) the policy string
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device,want", [
    ("cpu", torch.float32), ("cuda", torch.bfloat16),
    (torch.device("cuda", 0), torch.bfloat16)])
def test_auto_is_bf16_on_cuda_and_float32_on_the_cpu(device, want):
    # a device name is enough: nothing here needs a card
    assert resolve_dtype("auto", device) == want
    # the JAX package on this CPU: float32 as well
    assert np.dtype(jax_resolve_dtype("auto")) == np.float32


@pytest.mark.parametrize("name", ["float32", "bfloat16", "float64"])
def test_explicit_dtypes_resolve_as_in_jax(name):
    assert resolve_dtype(name, CPU) == getattr(torch, name)
    assert str(jax_resolve_dtype(name)) == name


@pytest.mark.parametrize("name,device", [
    ("float16", "cpu"), ("half", "cpu"), ("bf16", "cpu"),
    ("float64", "cuda")])
def test_other_dtypes_raise(name, device):
    with pytest.raises(ValueError):
        resolve_dtype(name, device)
    if device == "cpu":
        with pytest.raises(ValueError):
            MonoDETR(device="cpu", compute_dtype=name, **TINY)


@pytest.mark.parametrize("cfg_value", [None, *COMPUTE_DTYPES])
def test_build_monodetr_reads_compute_dtype(cfg_value):
    """The yaml's ``compute_dtype`` reaches the model as in the JAX
    package's ``build_monodetr`` (monodetr.py:457); absent, "auto"."""
    cfg = {"hidden_dim": 64, "dim_feedforward": 64, "nheads": 4,
           "enc_layers": 1, "dec_layers": 1, "num_queries": 10,
           "num_depth_bins": 16}
    if cfg_value is not None:
        cfg["compute_dtype"] = cfg_value
    tm = build_monodetr(cfg, device="cpu")
    assert tm.compute_dtype == jax_build(cfg).compute_dtype \
        == (cfg_value or "auto")
    # the layers that carry the policy carry this one
    assert tm.encoder.layer0.self_attn.value_proj.compute_dtype \
        == tm.backbone.conv1.compute_dtype == tm.compute_dtype
    assert tm.encoder.layer0.self_attn.sampling_offsets.compute_dtype is None


# ---------------------------------------------------------------------------
# the two packages' models on the same weights
# ---------------------------------------------------------------------------

class _JaxDepthEncoderNoDropout(jax_dp.DepthEncoderLayer):
    dropout: float = 0.0


@pytest.fixture(scope="module")
def batch():
    return sample_batch(B, H, W)


@pytest.fixture(scope="module")
def variables(batch):
    jm = JaxMonoDETR(msda_backend="xla", compute_dtype="float32", **TINY)
    v = jax.jit(lambda *a: jm.init(jax.random.PRNGKey(0), *a))(
        *[batch[k][:1] for k in MODEL_INPUTS])
    return {"params": _spread_offsets(v["params"], np.random.default_rng(1)),
            "frozen": jax.tree_util.tree_map(np.asarray, v["frozen"])}


def _jax_model(compute_dtype, **kw):
    return JaxMonoDETR(msda_backend="xla", compute_dtype=compute_dtype,
                       **{**TINY, **kw})


def _port_model(variables, compute_dtype, **kw):
    tm = MonoDETR(device="cpu", compute_dtype=compute_dtype,
                  **{**TINY, **kw})
    return load_flax_params(tm, variables["params"], variables["frozen"])


def _jax_forward(compute_dtype, variables, batch):
    jm = _jax_model(compute_dtype)
    out = jax.jit(lambda v, *a: jm.apply(v, *a))(
        variables, *[batch[k] for k in MODEL_INPUTS])
    return {k: np.asarray(out[k]) for k in HEADS}


def _port_forward(compute_dtype, variables, batch):
    tm = _port_model(variables, compute_dtype)
    with torch.no_grad():
        out = tm(*[torch.from_numpy(batch[k]) for k in MODEL_INPUTS])
    for k in HEADS:
        assert out[k].dtype == torch.float32, k        # heads stay f32
    return {k: out[k].numpy() for k in HEADS}


@pytest.fixture(scope="module")
def forwards(variables, batch):
    return {(pkg, cd): fwd(cd, variables, batch)
            for pkg, fwd in (("jax", _jax_forward), ("port", _port_forward))
            for cd in ("float32", "bfloat16")}


def _errors(want, got):
    """The JAX package's statistics (tests/test_mixed_precision.py:46-51):
    |a - b| / (|a| + 1), its max, and for depth its 0.9 quantile."""
    out = {}
    for k in HEADS:
        err = np.abs(want[k] - got[k]) / (np.abs(want[k]) + 1.0)
        out[k] = {"max": float(err.max())}
        if k == "pred_depth":
            out[k]["q90"] = float(np.quantile(err, 0.9))
    return out


def _within_jax_bars(errs, what):
    print(json.dumps({"mixed_precision": what, "errors": errs}))
    for k, e in errs.items():
        if k == "pred_depth":
            assert e["q90"] < 0.1 and e["max"] < 0.6, (what, k, e)
        else:
            assert e["max"] < 0.15, (what, k, e)


# ---------------------------------------------------------------------------
# (b) the dtype of every submodule's output
# ---------------------------------------------------------------------------

def _dtype_names(out):
    if isinstance(out, (tuple, list)):
        names = tuple(_dtype_names(o) for o in out)
        return None if None in names else names
    dt = getattr(out, "dtype", None)
    if dt is None or isinstance(out, dict):
        return None
    return str(dt).replace("torch.", "")


def _jax_dtype_map(variables, batch, training):
    """Flax path -> (module class, output dtypes) of every submodule call
    under compute_dtype="bfloat16", traced abstractly."""
    jm = _jax_model("bfloat16", dropout=0.0)
    seen = {}

    def record(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.method_name == "__call__" and context.module.path:
            seen.setdefault(tuple(context.module.path), (
                type(context.module).__name__, set()))[1].add(
                    _dtype_names(out))
        return out

    def apply(v, *a):
        with fnn.intercept_methods(record):
            return jm.apply(v, *a, training=training,
                            rngs={"dropout": jax.random.PRNGKey(0)})

    jax.eval_shape(apply, variables, *[batch[k] for k in MODEL_INPUTS])
    return seen


def _port_dtype_map(variables, batch, training):
    tm = _port_model(variables, "bfloat16", dropout=0.0)
    tm.train(training)
    seen = {}
    for name, mod in tm.named_modules():
        if name:
            mod.register_forward_hook(
                lambda m, a, out, name=name: seen.setdefault(
                    name, set()).add(_dtype_names(out)))
    with torch.no_grad():
        tm(*[torch.from_numpy(batch[k]) for k in MODEL_INPUTS])
    return tm, seen


def _port_name(tm, path):
    """The port module that holds the Flax path's params (convert.py's
    names), or None."""
    mod, names = tm, []
    for key in path:
        name = AUTO_NAMES.get(type(mod), {}).get(key, key)
        try:
            mod = mod.get_submodule(name)
        except AttributeError:
            return None
        names.append(name)
    return ".".join(names)


@pytest.mark.parametrize("training", [False, True])
def test_dtype_map_equals_jax(variables, batch, training):
    """Every submodule's output dtype under bfloat16, module by module
    through the weight bridge's names, equals the JAX package's; the
    modules compared cover every port module with params or buffers."""
    jmap = _jax_dtype_map(variables, batch, training)
    tm, tmap = _port_dtype_map(variables, batch, training)
    compared, unmapped = {}, set()
    for path, (cls, dtypes) in jmap.items():
        name = _port_name(tm, path)
        if name is None:
            unmapped.add(cls)
            continue
        assert tmap.get(name) == dtypes, (name, tmap.get(name), dtypes)
        compared[name] = sorted(map(str, dtypes))
    # the Flax modules without a port module of their name hold no params
    assert unmapped <= {"Dropout"}, unmapped
    held = {n for n, m in tm.named_modules()
            if n and (list(m.parameters(recurse=False))
                      or list(m.buffers(recurse=False)))}
    assert held <= set(compared), sorted(held - set(compared))
    print(json.dumps({"dtype_map": f"training={training}",
                      "modules": len(compared),
                      "bf16_out": sum("bfloat16" in str(d)
                                      for d in compared.values())}))
    # the policy's landmarks
    for name in ("backbone", "input_proj0", "encoder.layer0.self_attn."
                 "value_proj", "encoder.layer0.self_attn",
                 "decoder_layer0.self_attn"):
        assert "bfloat16" in str(compared[name]), name
    for name in ("input_norm0", "encoder.layer0.self_attn.sampling_offsets",
                 "encoder.layer0.self_attn.attention_weights",
                 "class_embed0", "depth_predictor.classifier", "encoder"):
        assert compared[name] == ["float32"], (name, compared[name])


# ---------------------------------------------------------------------------
# (c) the bf16 forward
# ---------------------------------------------------------------------------

def test_bf16_forward_matches_jax_bf16(forwards):
    for (pkg, cd), out in forwards.items():
        for k in HEADS:
            assert np.isfinite(out[k]).all(), (pkg, cd, k)
    _within_jax_bars(_errors(forwards["jax", "bfloat16"],
                             forwards["port", "bfloat16"]),
                     "port bf16 vs JAX bf16")


def test_float32_forwards_agree(forwards):
    # the float32 models agree as tests/test_torch_slice.py holds them
    for k in HEADS:
        want, got = forwards["jax", "float32"][k], forwards["port",
                                                            "float32"][k]
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got / scale, want / scale, atol=2e-4)


def test_bf16_error_at_most_twice_jax(forwards):
    """The port's bf16-vs-float32 error, statistic by statistic, within
    twice the JAX package's on the same params.  (At these two decoder
    layers the JAX package's own bf16 depth strays from its float32 one by
    more than its test's 0.6 at one decoder layer: 0.81 at the largest.)"""
    port = _errors(forwards["port", "float32"], forwards["port", "bfloat16"])
    jx = _errors(forwards["jax", "float32"], forwards["jax", "bfloat16"])
    print(json.dumps({"mixed_precision": "bf16 vs f32", "port": port,
                      "jax": jx}))
    for k in HEADS:
        for stat, e in port[k].items():
            assert e <= 2.0 * jx[k][stat], (k, stat, e, jx[k][stat])


# ---------------------------------------------------------------------------
# (d) the bf16 train step
# ---------------------------------------------------------------------------

def _no_dropout(model):
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.p = 0.0
    return model


def _port_ccfg():
    return crit.CriterionConfig(group_num=TINY["group_num"],
                                num_queries=TINY["num_queries"],
                                num_classes=3)


def test_bf16_step_loss_dict_matches_jax(variables, batch):
    """One bf16 train step's loss dict (the training-mode forward and the
    criterion before the update, dropout off) against the JAX package's
    bf16 forward and criterion, on the bars of
    tests/test_mixed_precision.py:51."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_dp, "DepthEncoderLayer", _JaxDepthEncoderNoDropout)
        jm = _jax_model("bfloat16", dropout=0.0)
        jbatch = {k: np.asarray(a) for k, a in batch.items()}
        ccfg = jax_crit.CriterionConfig(
            group_num=TINY["group_num"], num_queries=TINY["num_queries"],
            num_classes=3, matcher=JaxMatcherConfig(backend="jv"))
        j_losses = jax.jit(lambda v, *a: jax_crit.criterion(
            jm.apply(v, *a, training=True), jax_targets(jbatch), ccfg,
            training=True))(variables, *[jbatch[k] for k in MODEL_INPUTS])
        j_losses = {k: float(x) for k, x in j_losses.items()}

    tm = _no_dropout(_port_model(variables, "bfloat16", dropout=0.0))
    opt = optim.make_optimizer(tm, 2e-4, 1e-4)
    t_losses = make_train_step(tm, _port_ccfg(), opt)(batch)
    assert set(j_losses) <= set(t_losses)
    err = {k: abs(t_losses[k] - j) / (abs(j) + 1.0)
           for k, j in j_losses.items()}
    print(json.dumps({"mixed_precision": "bf16 step loss dict, port vs "
                      "JAX", "max": max(err.values()),
                      "worst": max(err, key=err.get)}))
    assert all(np.isfinite(v) for v in t_losses.values())
    for k, e in err.items():
        assert e < 0.15, (k, t_losses[k], j_losses[k])


def test_bf16_steps_learn_with_float32_params(variables, batch):
    """Six bf16 steps lower the loss (tests/test_mixed_precision.py:54-79);
    params, their gradients and AdamW's moments stay float32."""
    tm = _port_model(variables, "bfloat16")
    opt = optim.make_optimizer(tm, 1e-3, 1e-4)
    step = make_train_step(tm, _port_ccfg(), opt)
    gen = torch.Generator().manual_seed(0)
    history = [step(batch, gen) for _ in range(6)]
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert all(p.grad.dtype == torch.float32 for p in tm.parameters()
               if p.grad is not None)
    moments = [t for st in opt.state.values() for t in st.values()
               if torch.is_tensor(t) and t.is_floating_point() and t.dim()]
    assert moments and all(t.dtype == torch.float32 for t in moments)
    first, last = history[0]["loss_total"], history[-1]["loss_total"]
    print(json.dumps({"mixed_precision": "bf16 steps", "loss_total":
                      [h["loss_total"] for h in history]}))
    assert np.isfinite(last) and last < first
    assert history[-1]["grad_norm"] > 0


def test_one_param_tree_for_both_policies(variables):
    """``load_flax_params`` fills the float32 and the bf16 model from the
    same float32 Flax tree (tests/test_mixed_precision.py:34-36), and both
    hold it as float32, tensor for tensor."""
    t32 = _port_model(variables, "float32")
    t16 = _port_model(variables, "bfloat16")
    s32, s16 = t32.state_dict(), t16.state_dict()
    assert sorted(s32) == sorted(s16)
    for name, t in s32.items():
        assert t.dtype == s16[name].dtype == torch.float32, name
        assert torch.equal(t, s16[name]), name


def test_train_val_run_builds_the_yaml_policy(tmp_path, monkeypatch):
    """``tools/train_val_torch.py`` ``run`` hands the yaml's
    ``compute_dtype`` to the model; its checkpoint holds float32 params in
    the same format as a float32 run's, and a float32 model restores it."""
    from monosowa_tpu_torch.models import monodetr
    from monosowa_tpu_torch.train import checkpoint
    from monosowa_tpu_torch.train.sample import SampleDataset

    monkeypatch.syspath_prepend(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "tools"))
    import train_val_torch

    built = []

    def build(cfg, **kw):
        built.append(build_monodetr(cfg, **kw))
        return built[-1]

    monkeypatch.setattr(monodetr, "build_monodetr", build)
    h, w = 64, 96
    ds_cfg = {"resolution": [w, h], "max_objs": 4, "batch_size": 1,
              "root_dir": str(tmp_path)}
    model_cfg = {"enc_layers": 1, "dec_layers": 1, "hidden_dim": 64,
                 "dim_feedforward": 64, "nheads": 4, "num_queries": 5,
                 "num_depth_bins": 8, "compute_dtype": "bfloat16"}
    record = train_val_torch.run(
        {"dataset": ds_cfg, "model": model_cfg,
         "trainer": {"max_epoch": 1, "save_path": str(tmp_path / "out")},
         "tester": {"threshold": 0.0, "topk": 5}},
        SampleDataset(1, ds_cfg), SampleDataset(2, ds_cfg, first_id=2),
        "cpu", logger=lambda s: None)
    assert [m.compute_dtype for m in built] == ["bfloat16"]
    assert np.isfinite(record["epochs"][0]["loss_total"]).all()
    path = checkpoint.latest_checkpoint(str(tmp_path / "out"))
    saved = torch.load(path, weights_only=True)["model"]
    f32 = build_monodetr({**model_cfg, "compute_dtype": "float32"},
                         device="cpu")
    assert sorted(saved) == sorted(f32.state_dict())
    assert all(t.dtype == torch.float32 for t in saved.values())
    checkpoint.restore_checkpoint(path, f32)
