"""The detector's variants in the torch port against the JAX package's:
``two_stage``, ``use_dab``, ``position_embedding: learned`` and
``use_depth`` (the JAX package's models/monodetr.py:122-209, :271-286,
:359-402), and their parts: ``LearnedPositionEmbedding``, the 4-channel
RGB-D stem, and the output dtype of every submodule under bfloat16.

Sizes as in tests/test_torch_train.py: d_model 64, 4 heads, 1 encoder and 2
decoder layers, 10 queries x 2 Group-DETR groups, 16 depth bins, two 96x160
images (S = 321 encoder tokens).  The JAX weights are carried over by
``load_flax_params``, with the zero-initialised sampling-offset and
attention-weight kernels spread as in tests/test_torch_slice.py.  Both
models run in eval mode and in training mode without dropout (the JAX
depth encoder's fixed 0.1 set to 0 in a subclass, as
tests/test_torch_train_step.py does).  Tolerances: 2e-4 of each output's
largest magnitude for the whole model (tests/test_torch_slice.py's bar),
2e-5 for the position embedding and the stem.  Each comparison prints its
largest difference as a JSON line (``pytest -s``).
"""

import json

import jax
import numpy as np
import pytest
import torch

from flax import linen as fnn
from monosowa_tpu.models import depth_predictor as jax_dp
from monosowa_tpu.models.backbone import ResNet50 as JaxResNet50
from monosowa_tpu.models.monodetr import MonoDETR as JaxMonoDETR
from monosowa_tpu.models.position_encoding import \
    LearnedPositionEmbedding as JaxLearned
from monosowa_tpu_torch.convert import load_flax_params
from monosowa_tpu_torch.models.backbone import ResNet50
from monosowa_tpu_torch.models.layers import Dropout
from monosowa_tpu_torch.models.monodetr import MonoDETR, build_monodetr
from monosowa_tpu_torch.models.position_encoding import \
    LearnedPositionEmbedding
from test_torch_mixed_precision import _dtype_names, _port_name
from test_torch_slice import _spread_offsets
from test_torch_train import _one_torch_thread  # noqa: F401 (autouse)

TINY = dict(enc_layers=1, dec_layers=2, group_num=2, d_model=64, d_ffn=64,
            nheads=4, num_queries=10, num_depth_bins=16)
B, H, W = 2, 96, 160
TOL = 2e-4
PART_TOL = 2e-5
VARIANTS = {"two_stage": {"two_stage": True},
            "use_dab": {"use_dab": True},
            "learned": {"position_embedding": "learned"},
            "use_depth": {"use_depth": True}}
HEADS = ("pred_logits", "pred_boxes", "pred_depth", "pred_3d_dim",
         "pred_angle")
OUTPUT_KEYS = HEADS + ("weighted_depth", "pred_depth_map_logits")


class _JaxDepthEncoderNoDropout(jax_dp.DepthEncoderLayer):
    dropout: float = 0.0


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-12)
    rel = float(np.abs(got - want).max()) / scale
    print(json.dumps({"port_vs_jax": what, "max_rel": rel}))
    np.testing.assert_allclose(got / scale, want / scale, atol=tol,
                               err_msg=what)


def inputs(channels=3, seed=0):
    rng = np.random.default_rng(seed)
    calib = np.tile(np.array([[700.0, 0, W / 2, 0], [0, 700.0, H / 2, 0],
                              [0, 0, 1, 0]], np.float32), (B, 1, 1))
    return (rng.normal(size=(B, H, W, channels)).astype(np.float32), calib,
            np.tile(np.array([W, H], np.float32), (B, 1)))


def jax_variables(jm, args, first_image: bool = True, **kw):
    if first_image:
        args = [a[:1] for a in args]
    v = jax.jit(lambda *a: jm.init(jax.random.PRNGKey(0), *a, **kw))(*args)
    return {"params": _spread_offsets(v["params"], np.random.default_rng(1)),
            "frozen": jax.tree_util.tree_map(np.asarray, v["frozen"])}


def no_dropout(model):
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.p = 0.0
    return model


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def variant(request):
    """Both packages' forwards of one variant in eval and training mode."""
    flags = VARIANTS[request.param]
    args = inputs(4 if flags.get("use_depth") else 3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_dp, "DepthEncoderLayer", _JaxDepthEncoderNoDropout)
        jm = JaxMonoDETR(msda_backend="xla", compute_dtype="float32",
                         dropout=0.0, **TINY, **flags)
        v = jax_variables(jm, args)
        j_out = {}
        for training in (False, True):
            j_out[training] = _to_numpy(jax.jit(
                lambda v, *a, t=training: jm.apply(
                    v, *a, training=t,
                    rngs={"dropout": jax.random.PRNGKey(0)}))(v, *args))
    tm = no_dropout(MonoDETR(device="cpu", dropout=0.0, **TINY, **flags))
    load_flax_params(tm, v["params"], v["frozen"])
    t_out = {}
    for training in (False, True):
        tm.train(training)
        with torch.no_grad():
            t_out[training] = tm(*[torch.from_numpy(a) for a in args])
    return dict(name=request.param, flags=flags, args=args, variables=v,
                j_out=j_out, t_out=t_out)


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("key", OUTPUT_KEYS)
def test_variant_forward_matches_jax(variant, training, key):
    _close(variant["t_out"][training][key].numpy(),
           variant["j_out"][training][key], TOL,
           f"{variant['name']} training={training} {key}")


@pytest.mark.parametrize("training", [False, True])
def test_variant_aux_and_enc_outputs_match_jax(variant, training):
    """The aux layers' heads, and under two_stage the encoder proposals'
    ``enc_outputs`` (all S = 321 tokens) and the query count (top-k 20 in
    training, 10 in eval)."""
    t, j = variant["t_out"][training], variant["j_out"][training]
    assert len(t["aux_outputs"]) == len(j["aux_outputs"]) == 1
    for key in HEADS:
        _close(t["aux_outputs"][0][key].numpy(), j["aux_outputs"][0][key],
               TOL, f"{variant['name']} training={training} aux {key}")
    nq = TINY["num_queries"] * (TINY["group_num"] if training else 1)
    assert t["pred_logits"].shape == (B, nq, 3)
    assert ("enc_outputs" in t) == ("enc_outputs" in j) == \
        bool(variant["flags"].get("two_stage"))
    if "enc_outputs" in j:
        for key in ("pred_logits", "pred_boxes"):
            got = t["enc_outputs"][key].numpy()
            assert got.shape[:2] == (B, 321)
            _close(got, j["enc_outputs"][key], TOL,
                   f"{variant['name']} training={training} enc {key}")


def test_variant_params_are_the_jax_models(variant):
    """The port builds the JAX model's parameters and no others: every
    Flax leaf filled, every port tensor filled (``load_flax_params``
    raises otherwise), the tables of the other query kinds absent."""
    tm = MonoDETR(device="cpu", **TINY, **variant["flags"])
    load_flax_params(tm, variant["variables"]["params"],
                     variant["variables"]["frozen"])
    names = dict(tm.named_parameters())
    two, dab = (variant["flags"].get(k, False) for k in ("two_stage",
                                                           "use_dab"))
    assert ("query_embed" in names) == (not two and not dab)
    assert ("tgt_embed" in names) == (dab and not two)
    assert ("dab_ref_point_head.layers.0.weight" in names) == dab
    assert ("enc_class.bias" in names) == two
    learned = variant["flags"].get("position_embedding") == "learned"
    assert ("position_embedding.row_embed.embedding" in names) == learned
    c_in = 4 if variant["flags"].get("use_depth") else 3
    assert tuple(names["backbone.conv1.weight"].shape) == (64, c_in, 7, 7)


# ---------------------------------------------------------------------------
# the parts: learned position embedding, RGB-D stem
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(12, 20), (6, 10), (48, 160), (50, 3)])
def test_learned_position_embedding_matches_jax(hw):
    jl = JaxLearned(32)
    params = jl.init(jax.random.PRNGKey(3), *hw)["params"]
    rng = np.random.default_rng(4)
    params = {k: {"embedding": rng.normal(size=(50, 32)).astype(np.float32)}
              for k in params}
    want = np.asarray(jl.apply({"params": params}, *hw))
    tl = LearnedPositionEmbedding(torch.Generator().manual_seed(0), 32)
    load_flax_params(tl, params)
    got = tl(*hw).detach().numpy()
    assert got.shape == hw + (64,)
    _close(got, want, PART_TOL, f"learned position embedding {hw}")


def test_rgbd_stem_matches_jax():
    """ResNet-50 with the 4-channel stem: C3, C4, C5 against the JAX
    backbone on the same weights; the stem's fresh init is xavier-uniform
    over fan-in 4 x 49 and fan-out 64 x 49, as Flax's."""
    x = inputs(4, seed=5)[0]
    jr = JaxResNet50(depth_input=True)
    v = jax.jit(lambda a: jr.init(jax.random.PRNGKey(0), a))(x[:1])
    want = jax.jit(jr.apply)(v, x)
    tr = ResNet50(torch.Generator().manual_seed(0), depth_input=True)
    limit = float(np.sqrt(6.0 / (4 * 49 + 64 * 49)))
    w = tr.conv1.weight.detach()
    assert tuple(w.shape) == (64, 4, 7, 7)
    assert float(w.abs().max()) <= limit and float(w.std()) > 0.5 * limit
    load_flax_params(tr, _to_numpy(v["params"]), _to_numpy(v["frozen"]))
    with torch.no_grad():
        got = tr(torch.from_numpy(x).permute(0, 3, 1, 2))
    for i, (g, j) in enumerate(zip(got, want)):
        _close(g.permute(0, 2, 3, 1).numpy(), np.asarray(j), PART_TOL,
               f"rgbd stem C{i + 3}")


def test_build_monodetr_reads_the_variant_keys():
    """The keys the JAX ``build_monodetr`` reads (its monodetr.py:436-458)
    reach the model; use_dn and with_box_refine, which it ignores, raise
    at their unshipped values."""
    cfg = {"hidden_dim": 64, "dim_feedforward": 64, "nheads": 4,
           "enc_layers": 1, "dec_layers": 2, "num_queries": 10,
           "num_depth_bins": 16, "two_stage": True, "use_depth": True,
           "position_embedding": "learned"}
    m = build_monodetr(cfg, device="cpu")
    assert m.two_stage and not m.use_dab
    assert m.position_embedding is not None
    assert m.backbone.conv1.weight.shape[1] == 4
    m = build_monodetr({**cfg, "two_stage": False, "use_dab": True},
                       device="cpu")
    assert m.use_dab and hasattr(m, "refpoint_embed")
    for bad in ({"use_dn": True}, {"with_box_refine": False}):
        with pytest.raises(NotImplementedError):
            build_monodetr({**cfg, **bad}, device="cpu")


# ---------------------------------------------------------------------------
# bfloat16: the output dtype of every submodule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_dtype_map_equals_jax(name):
    """Under compute_dtype="bfloat16", in training mode, every submodule's
    output dtype equals the JAX model's, module by module through the
    weight bridge's names (tests/test_torch_mixed_precision.py's map); the
    variant's new modules are among those compared."""
    flags = VARIANTS[name]
    args = inputs(4 if flags.get("use_depth") else 3)
    jm = JaxMonoDETR(msda_backend="xla", compute_dtype="bfloat16",
                     dropout=0.0, **TINY, **flags)
    v = jax.eval_shape(lambda *a: jm.init(jax.random.PRNGKey(0), *a),
                       *[a[:1] for a in args])
    v = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), v)
    jmap = {}

    def record(next_fun, a, kw, context):
        out = next_fun(*a, **kw)
        if context.method_name == "__call__" and context.module.path:
            jmap.setdefault(tuple(context.module.path), (
                type(context.module).__name__, set()))[1].add(
                    _dtype_names(out))
        return out

    def apply(v, *a):
        with fnn.intercept_methods(record):
            return jm.apply(v, *a, training=True,
                            rngs={"dropout": jax.random.PRNGKey(0)})

    jax.eval_shape(apply, v, *args)
    tm = no_dropout(MonoDETR(device="cpu", compute_dtype="bfloat16",
                             dropout=0.0, **TINY, **flags))
    tm.train()
    tmap = {}
    for mod_name, mod in tm.named_modules():
        if mod_name:
            mod.register_forward_hook(
                lambda m, a, out, n=mod_name: tmap.setdefault(
                    n, set()).add(_dtype_names(out)))
    with torch.no_grad():
        tm(*[torch.from_numpy(a) for a in args])
    compared, unmapped = {}, set()
    for path, (cls, dtypes) in jmap.items():
        port = _port_name(tm, path)
        if port is None:
            unmapped.add(cls)
            continue
        assert tmap.get(port) == dtypes, (port, tmap.get(port), dtypes)
        compared[port] = sorted(map(str, dtypes))
    assert unmapped <= {"Dropout"}, unmapped
    held = {n for n, m in tm.named_modules()
            if n and (list(m.parameters(recurse=False))
                      or list(m.buffers(recurse=False)))}
    assert held <= set(compared), sorted(held - set(compared))
    new = {"two_stage": ("enc_output", "enc_output_norm", "enc_class",
                         "enc_bbox", "pos_trans", "pos_trans_norm"),
           "use_dab": ("dab_ref_point_head", "dab_query_scale"),
           "learned": ("position_embedding", "position_embedding.row_embed"),
           "use_depth": ("backbone.conv1",)}[name]
    for mod_name in new:
        assert mod_name in compared, mod_name
    print(json.dumps({"dtype_map": name, "modules": len(compared),
                      "new": {n: compared[n] for n in new}}))
