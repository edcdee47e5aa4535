"""Public checkpoints into the port without JAX: ``sowa/hf_checkpoint.py``
(the reader of a local checkpoint directory), the port's ``import_hf_*`` /
``import_torch_tracker`` / ``load_torch_resnet_state`` and
``tools/import_zoo_checkpoint_torch.py``, against transformers and the JAX
package's importers on the CPU.

Each kind is the JAX parity tests' tiny transformers model with seeded
weights, written by ``save_pretrained``: Mask2Former and SAM as
safetensors, Depth Anything as ``pytorch_model.bin``, EfficientLoFTR as a
BF16 safetensors file.  The port's tool turns each directory into a zoo
``.npz``; held:

* the file's tree against the JAX importer's on ``state_dict()`` (bf16:
  the same tensors cast to float32), array for array, equal; its config
  against the JAX ``config_from_hf_*`` of the transformers config, equal;
  the JAX package's ``load_checkpoint`` reads the file;
* the port's forward from the file against transformers' forward, at the
  JAX parity tests' tolerances (Mask2Former classes 2e-3 / 1e-3, masks
  5e-3 / 1e-3; Depth Anything and DINOv2 2e-4 / 1e-4; SAM masks 5e-4 /
  1e-4, IoU 2e-4 / 1e-4; EfficientLoFTR features 5e-4 / 1e-3, the
  coarse transformer 2e-3 / 1e-2, atol / rtol);
* the full-width manifests (``sowa/hf_manifests``) against transformers'
  models built on the meta device, and the reader's gap filling against
  transformers' config classes;
* ResNet-50: the port's ``load_torch_resnet_state`` against the JAX one on
  tests/test_backbone_import.py's torchvision layout, C3-C5 at 2e-5 of
  their magnitude, with the RGB-D stem rule.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from monosowa_tpu.models import backbone as jbackbone  # noqa: E402
from monosowa_tpu.models import depth_anything as jda  # noqa: E402
from monosowa_tpu.models import dinov2 as jdn  # noqa: E402
from monosowa_tpu.models import efficientloftr as jelo  # noqa: E402
from monosowa_tpu.models import mask2former as jm2f  # noqa: E402
from monosowa_tpu.models import sam as jsam  # noqa: E402
from monosowa_tpu.models import vit_tracker as jvt  # noqa: E402
from monosowa_tpu.sowa import zoo as jzoo  # noqa: E402
from monosowa_tpu_torch.convert import load_zoo_params  # noqa: E402
from monosowa_tpu_torch.models import backbone  # noqa: E402
from monosowa_tpu_torch.models import depth_anything as da  # noqa: E402
from monosowa_tpu_torch.models import dinov2 as dn  # noqa: E402
from monosowa_tpu_torch.models import efficientloftr as elo  # noqa: E402
from monosowa_tpu_torch.models import mask2former as m2f  # noqa: E402
from monosowa_tpu_torch.models import sam  # noqa: E402
from monosowa_tpu_torch.models import vit_tracker as vt  # noqa: E402
from monosowa_tpu_torch.sowa import hf_checkpoint as hfc  # noqa: E402
from monosowa_tpu_torch.sowa import zoo  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import hf_manifests  # noqa: E402
import import_zoo_checkpoint_torch as tool  # noqa: E402

torch.set_num_threads(1)    # the suite runs six worker processes at once

KINDS = ("mask2former", "depth_anything", "sam", "loftr")
FORMAT = {"mask2former": "safetensors", "depth_anything": "bin",
          "sam": "safetensors", "loftr": "bf16"}
JAX_IMPORT = {
    "mask2former": (jm2f.config_from_hf_mask2former,
                    jm2f.import_hf_mask2former),
    "depth_anything": (jda.config_from_hf_depth_anything,
                       jda.import_hf_depth_anything),
    "sam": (jsam.config_from_hf_sam, jsam.import_hf_sam),
    "loftr": (jelo.config_from_hf_efficientloftr,
              jelo.import_hf_efficientloftr),
}
PORT_CONFIG = {"mask2former": m2f.config_from_hf_mask2former,
               "depth_anything": da.config_from_hf_depth_anything,
               "sam": sam.config_from_hf_sam,
               "loftr": elo.config_from_hf_efficientloftr}


def tiny_model(kind):
    """The JAX parity tests' tiny configuration of each kind, seeded
    weights, eval mode."""
    if kind == "mask2former":
        from test_mask2former_parity import _tiny_m2f
        torch.manual_seed(0)
        return transformers.Mask2FormerForUniversalSegmentation(
            _tiny_m2f()).eval()
    if kind == "depth_anything":
        from test_depth_anything_parity import _tiny_hf_dinov2
        cfg = transformers.DepthAnythingConfig(
            backbone_config=_tiny_hf_dinov2(), patch_size=14,
            reassemble_hidden_size=32, reassemble_factors=[4, 2, 1, 0.5],
            neck_hidden_sizes=[8, 16, 24, 32], fusion_hidden_size=16,
            head_hidden_size=8, depth_estimation_type="metric",
            max_depth=80.0)
        torch.manual_seed(0)
        return transformers.DepthAnythingForDepthEstimation(cfg).eval()
    if kind == "sam":
        from test_sam_parity import _tiny_hf_config
        torch.manual_seed(0)
        return transformers.SamModel(_tiny_hf_config()).eval()
    from test_efficientloftr_parity import _tiny_hf_config
    torch.manual_seed(0)
    return transformers.EfficientLoFTRForKeypointMatching(
        _tiny_hf_config()).eval()


def fields(cfg):
    """A config dataclass as a dict of plain values, sequences as
    tuples."""
    def plain(v):
        if dataclasses.is_dataclass(v):
            return fields(v)
        return tuple(v) if isinstance(v, (list, tuple)) else v
    return {f.name: plain(getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)}


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """kind -> (transformers model with the weights as read back, its
    checkpoint directory, the tool's .npz)."""
    root = tmp_path_factory.mktemp("hf")
    out = {}
    for kind in KINDS:
        tm = tiny_model(kind)
        d = str(root / kind)
        if FORMAT[kind] == "bf16":
            tm.to(torch.bfloat16).save_pretrained(d)
            tm.to(torch.float32)        # the bf16 values, widened
        else:
            tm.save_pretrained(d, safe_serialization=FORMAT[kind]
                               != "bin")
        npz = str(root / f"{kind}.npz")
        tool.main(["--kind", kind, "--hf", d, "--out", npz])
        out[kind] = (tm, d, npz)
    return out


def test_directories_hold_the_formats(converted):
    files = {k: sorted(os.listdir(d)) for k, (_, d, _) in converted.items()}
    assert files["depth_anything"] == ["config.json", "pytorch_model.bin"]
    for kind in ("mask2former", "sam", "loftr"):
        assert files[kind] == ["config.json", "model.safetensors"], kind
    with open(os.path.join(converted["loftr"][1], "model.safetensors"),
              "rb") as f:
        n = int(np.frombuffer(f.read(8), "<u8")[0])
        header = json.loads(f.read(n))
    assert {v["dtype"] for k, v in header.items()
            if k != "__metadata__"} == {"BF16", "I64"}


@pytest.mark.parametrize("kind", KINDS)
def test_tool_file_equals_the_jax_importer(converted, kind):
    """The tool's tree, array for array, and its config, field for field,
    against the JAX importer on the model's state dict; the JAX package's
    ``load_checkpoint`` reads the file."""
    tm, _, npz = converted[kind]
    jconfig, jimport = JAX_IMPORT[kind]
    jcfg = jconfig(tm.config)
    want = zoo.flatten_params(jimport(tm.state_dict(), jcfg))
    got_kind, tree, cfg = zoo.load_checkpoint(npz)
    got = zoo.flatten_params(tree)
    assert got_kind == kind and sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert fields(cfg) == fields(jcfg)
    jkind, jtree, jcfg2 = jzoo.load_checkpoint(npz)
    assert jkind == kind and fields(jcfg2) == fields(jcfg)
    jflat = jzoo.flatten_params(jtree)
    assert sorted(jflat) == sorted(want)
    np.testing.assert_array_equal(jflat[sorted(want)[0]],
                                  want[sorted(want)[0]])


def _port(kind, npz):
    _, tree, cfg = zoo.load_checkpoint(npz)
    net = {"mask2former": m2f.Mask2Former, "depth_anything": da.DepthAnything,
           "sam": sam.Sam, "loftr": elo.EfficientLoFTR}[kind]
    return load_zoo_params(net(cfg, device="cpu"), tree), cfg


def test_mask2former_forward_matches_transformers(converted):
    tm, _, npz = converted["mask2former"]
    model, _ = _port("mask2former", npz)
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        ref = tm(pixel_values=x)
        classes, masks = model(x.permute(0, 2, 3, 1).contiguous())
    np.testing.assert_allclose(classes.numpy(),
                               ref.class_queries_logits.numpy(),
                               atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(masks.numpy(),
                               ref.masks_queries_logits.numpy(),
                               atol=5e-3, rtol=1e-3)


def test_depth_anything_forward_matches_transformers(converted):
    tm, _, npz = converted["depth_anything"]
    model, _ = _port("depth_anything", npz)
    x = torch.randn(2, 3, 56, 70, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        ref = tm(pixel_values=x).predicted_depth.numpy()
        got = model(x.permute(0, 2, 3, 1).contiguous()).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-4)


def test_sam_forward_matches_transformers(converted):
    tm, _, npz = converted["sam"]
    model, _ = _port("sam", npz)
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(2))
    boxes = torch.tensor([[[2.0, 3.0, 20.0, 28.0], [8.0, 1.0, 30.0, 12.0]],
                          [[0.0, 0.0, 31.0, 31.0], [5.0, 5.0, 9.0, 22.0]]])
    with torch.no_grad():
        out = tm(pixel_values=x, input_boxes=boxes, multimask_output=False)
        masks, iou = model.predict_boxes(x.permute(0, 2, 3, 1), boxes)
    np.testing.assert_allclose(masks.numpy(), out.pred_masks.numpy(),
                               atol=5e-4, rtol=1e-4)
    np.testing.assert_allclose(iou.numpy(), out.iou_scores.numpy(),
                               atol=2e-4, rtol=1e-4)


def test_loftr_forward_matches_transformers(converted):
    """The bf16 file's weights (widened) in the port against the stock
    model on the same widened weights: the fused RepVGG features and the
    coarse transformer, as tests/test_efficientloftr_parity.py holds the
    JAX module."""
    tm, _, npz = converted["loftr"]
    model, cfg = _port("loftr", npz)
    g = torch.Generator().manual_seed(1)
    gray = torch.rand(1, 2, 1, 64, 64, generator=g)
    with torch.no_grad():
        feats = tm.efficientloftr(
            gray.expand(-1, -1, 3, -1, -1).contiguous()).feature_maps
        tf = model.repvgg_forward(gray[:, :, 0].reshape(2, 64, 64, 1))
        for got, want in ((tf[0], feats[1]), (tf[1], feats[2])):
            np.testing.assert_allclose(got.permute(0, 3, 1, 2).numpy(),
                                       want.numpy(), atol=5e-4, rtol=1e-3)
        ah = (8 - cfg.q_aggregation_kernel_size) \
            // cfg.q_aggregation_stride + 1
        out = model.local_feature_transformer(
            tf[-1].reshape(1, 2, 8, 8, 32), model.rope(ah, ah, "cpu"))
    np.testing.assert_allclose(out.permute(0, 1, 4, 2, 3).numpy(),
                               feats[0].numpy(), atol=2e-3, rtol=1e-2)


def test_tool_refuses_what_it_cannot_read(tmp_path, capsys):
    with pytest.raises(SystemExit, match="must be on disk"):
        tool.main(["--kind", "sam", "--hf", "facebook/sam-vit-huge",
                   "--out", str(tmp_path / "x.npz")])
    with pytest.raises(SystemExit, match="training"):
        tool.main(["--kind", "vit_tracker", "--hf", str(tmp_path),
                   "--out", str(tmp_path / "x.npz")])
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"model_type": "sam"}, f)
    with pytest.raises(SystemExit, match="no model.safetensors"):
        tool.main(["--kind", "sam", "--hf", str(tmp_path),
                   "--out", str(tmp_path / "x.npz")])
    with pytest.raises(ValueError, match="model_type"):
        hfc.import_checkpoint("mask2former", hfc.config_tree(
            {"model_type": "sam"}), {})


# ---------------------------------------------------------------------------
# the reader
# ---------------------------------------------------------------------------

def test_safetensors_dtypes_and_shards(tmp_path):
    """F32, F16 and BF16 files read to float32 as torch widens them; a
    sharded index reads as one file; the reader's writer round-trips;
    pytorch_model.bin shards too."""
    g = torch.Generator().manual_seed(0)
    t = {"a.weight": torch.randn(3, 5, generator=g) * 1e3,
         "b.bias": torch.randn(7, generator=g),
         "c.n": torch.arange(4, dtype=torch.int64)}
    for dtype in (torch.float16, torch.bfloat16):
        src = {k: v.to(dtype) if v.is_floating_point() else v
               for k, v in t.items()}
        from safetensors.torch import save_file
        save_file(src, str(tmp_path / f"{dtype}.safetensors"))
        got = hfc.read_safetensors(str(tmp_path / f"{dtype}.safetensors"))
        for k, v in src.items():
            want = v.float().numpy() if v.is_floating_point() else v.numpy()
            assert got[k].dtype == want.dtype
            np.testing.assert_array_equal(got[k], want)
    # the port's writer, read by safetensors (float32 and bf16)
    from safetensors.numpy import load_file
    arrays = {k: v.numpy() for k, v in t.items()}
    hfc.write_safetensors(str(tmp_path / "w.safetensors"), arrays)
    back = load_file(str(tmp_path / "w.safetensors"))
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v)
    hfc.write_safetensors(str(tmp_path / "h.safetensors"), arrays, bf16=True)
    got = hfc.read_safetensors(str(tmp_path / "h.safetensors"))
    np.testing.assert_array_equal(
        got["a.weight"], t["a.weight"].bfloat16().float().numpy())
    # sharded, both formats
    tm = tiny_model("sam")
    for safe in (True, False):
        d = str(tmp_path / f"sharded_{safe}")
        tm.save_pretrained(d, max_shard_size="100KB",
                           safe_serialization=safe)
        index = [f for f in os.listdir(d) if f.endswith("index.json")]
        assert len(index) == 1
        state = hfc.read_state_dict(d)
        want = tm.state_dict()
        assert set(want) - set(state) == set()
        for k in ("vision_encoder.layers.2.attn.qkv.weight",
                  "mask_decoder.iou_token.weight"):
            np.testing.assert_array_equal(state[k], want[k].numpy())


def test_legacy_names_and_tied_table(tmp_path):
    """``LayerNorm.gamma`` / ``.beta`` renamed as ``from_pretrained``
    renames them; SAM's tied positional table filled from its twin."""
    assert hfc.rename_legacy_key("x.LayerNorm.gamma") == "x.LayerNorm.weight"
    assert hfc.rename_legacy_key("x.LayerNorm.beta") == "x.LayerNorm.bias"
    assert hfc.rename_legacy_key("x.norm.gamma") == "x.norm.gamma"
    table = np.arange(6, dtype=np.float32).reshape(2, 3)
    hfc.write_safetensors(str(tmp_path / "model.safetensors"), {
        "prompt_encoder.shared_embedding.positional_embedding": table,
        "enc.LayerNorm.gamma": table[0], "enc.LayerNorm.beta": table[1]})
    state = hfc.read_state_dict(str(tmp_path))
    np.testing.assert_array_equal(
        state["shared_image_embedding.positional_embedding"], table)
    assert sorted(state) == sorted([
        "prompt_encoder.shared_embedding.positional_embedding",
        "shared_image_embedding.positional_embedding",
        "enc.LayerNorm.weight", "enc.LayerNorm.bias"])


def _transformers_default(model_type):
    if model_type.startswith("sam."):
        return getattr(transformers.SamConfig(), model_type.split(".")[1])
    return transformers.CONFIG_MAPPING[model_type]()


@pytest.mark.parametrize("model_type", sorted(hfc.DEFAULTS))
def test_config_gaps_filled_as_transformers(model_type):
    """An empty config.json of each model type reads as the transformers
    class's defaults, derived values included."""
    want = _transformers_default(model_type)
    got = hfc.config_tree({}, model_type)
    keys = set(hfc.DEFAULTS[model_type]) | {"num_labels"}
    if model_type in ("swin", "dinov2", "dinov2_with_registers"):
        keys |= {"out_features", "out_indices", "stage_names"}
    if model_type == "sam.prompt_encoder_config":
        keys.add("image_embedding_size")
    for k in sorted(keys):
        w = getattr(want, k)
        assert getattr(got, k) == (list(w) if isinstance(w, tuple) else w), k
    if model_type in ("mask2former", "depth_anything"):
        bb = got.backbone_config
        for k in ("embed_dim", "depths", "out_features", "hidden_size",
                  "num_attention_heads", "image_size", "out_indices"):
            if hasattr(want.backbone_config, k) and hasattr(bb, k):
                assert getattr(bb, k) == getattr(want.backbone_config, k), k


def test_config_gaps_of_a_saved_config(tmp_path):
    """What ``save_pretrained`` leaves out: ``num_labels`` (only
    ``id2label`` is written), and a backbone that names only one of
    ``out_features`` / ``out_indices``."""
    cfg = transformers.Mask2FormerConfig(
        backbone_config=transformers.SwinConfig(
            embed_dim=8, depths=[1, 1, 1, 1], num_heads=[1, 2, 4, 8],
            window_size=2, out_indices=[2, 3, 4]), num_labels=5)
    cfg.save_pretrained(str(tmp_path))
    with open(tmp_path / "config.json") as f:
        raw = json.load(f)
    assert "num_labels" not in raw and len(raw["id2label"]) == 5
    del raw["backbone_config"]["out_features"]
    got = hfc.config_tree(raw)
    assert got.num_labels == 5
    assert got.backbone_config.out_features == ["stage2", "stage3", "stage4"]
    assert fields(m2f.config_from_hf_mask2former(got)) == fields(
        jm2f.config_from_hf_mask2former(cfg))


@pytest.mark.parametrize("swiglu,registers", [(False, 0), (True, 4)])
def test_dinov2_variants_through_the_reader(tmp_path, swiglu, registers):
    """DINOv2 with the GELU FFN, and with SwiGLU and register tokens (the
    antialiased position grid; tests/test_depth_anything_parity.py:84):
    config and tree read from a saved directory equal the JAX importer's,
    and the port's trunk matches transformers (2e-4 / 1e-4)."""
    if registers:
        hf_cfg = transformers.Dinov2WithRegistersConfig(
            image_size=28, patch_size=14, hidden_size=32,
            num_hidden_layers=3, num_attention_heads=2, mlp_ratio=4,
            use_swiglu_ffn=swiglu, num_register_tokens=registers)
        torch.manual_seed(2)
        tm = transformers.Dinov2WithRegistersModel(hf_cfg).eval()
    else:
        hf_cfg = transformers.Dinov2Config(
            image_size=28, patch_size=14, hidden_size=32,
            num_hidden_layers=3, num_attention_heads=2, mlp_ratio=4)
        torch.manual_seed(2)
        tm = transformers.Dinov2Model(hf_cfg).eval()
    tm.save_pretrained(str(tmp_path))
    cfg = dn.config_from_hf(hfc.read_config(str(tmp_path)))
    jcfg = jdn.config_from_hf(hf_cfg)
    assert fields(cfg) == fields(jcfg)
    assert cfg.use_swiglu_ffn == swiglu
    assert cfg.num_register_tokens == registers
    tree = dn.import_hf_dinov2(hfc.read_state_dict(str(tmp_path)), cfg)
    want = zoo.flatten_params(jdn.import_hf_dinov2(tm.state_dict(), jcfg))
    got = zoo.flatten_params(tree)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    model = load_zoo_params(dn.Dinov2(cfg, torch.Generator()), tree)
    x = torch.randn(2, 3, 28, 42, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        ref = tm(pixel_values=x).last_hidden_state.numpy()
        got = model.features(x.permute(0, 2, 3, 1).contiguous(),
                             [cfg.num_hidden_layers])[0].numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# the full-width manifests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_manifest_is_the_transformers_model(kind):
    """Each shipped configuration's manifest equals what transformers
    builds on the meta device (names, shapes, types, config.json), and
    the port reads its config as the JAX importer reads transformers'."""
    assert hfc.load_manifest(kind) == json.loads(hf_manifests.dumps(
        hf_manifests.hf_manifest(kind)))
    manifest = hfc.load_manifest(kind)
    got = PORT_CONFIG[kind](hfc.config_tree(manifest["config"]))
    want = JAX_IMPORT[kind][0](hf_manifests.hf_config(kind))
    assert fields(got) == fields(want)


def test_seeded_checkpoint_of_a_manifest_imports(tmp_path):
    """``write_seeded_checkpoint`` writes a directory the reader takes
    back (EfficientLoFTR at full width, float32 and bf16), and the tree it
    imports to loads into the port's module leaf for leaf."""
    for bf16 in (False, True):
        d = str(tmp_path / f"loftr_{bf16}")
        nbytes = hfc.write_seeded_checkpoint("loftr", d, seed=3, bf16=bf16)
        manifest = hfc.load_manifest("loftr")
        config, state = hfc.read_checkpoint_dir(d)
        assert [n for n, _, _ in manifest["tensors"]] == list(state)
        assert nbytes == sum(np.prod(s, dtype=np.int64) * (
            8 if t == "I64" else 2 if bf16 else 4)
            for _, s, t in manifest["tensors"])
        tree, cfg = hfc.import_checkpoint("loftr", config, state)
        assert cfg == elo.EfficientLoFTRConfig()
        load_zoo_params(elo.EfficientLoFTR(cfg, device="cpu"), tree)


# ---------------------------------------------------------------------------
# ResNet-50 and the tracker
# ---------------------------------------------------------------------------

def test_resnet_manifest_is_the_torchvision_layout():
    from test_backbone_import import synth_state_dict

    sd = synth_state_dict()
    manifest = {n: (s, t) for n, s, t in
                hfc.load_manifest("resnet50")["tensors"]}
    extra = {n for n in manifest if n.endswith("num_batches_tracked")}
    assert set(manifest) - set(sd) == extra | {"fc.weight", "fc.bias"}
    assert set(sd) <= set(manifest)
    for n, v in sd.items():
        assert manifest[n] == (list(v.shape), "F32"), n


@pytest.mark.parametrize("depth_input", [False, True])
def test_resnet_import_matches_jax(tmp_path, depth_input):
    """The port's ``load_torch_resnet_state`` and the JAX one on the same
    torchvision-layout file (with ``fc`` and ``num_batches_tracked``):
    C3-C5 within 2e-5 of their magnitude; the RGB-D stem keeps its fresh
    conv1 in both (the port's then set to the JAX one's for the
    comparison)."""
    path = str(tmp_path / "resnet50.pth")
    hfc.write_seeded_resnet50(path, seed=1)
    jmodel = jbackbone.ResNet50(depth_input=depth_input)
    c = 4 if depth_input else 3
    img = np.random.default_rng(1).normal(size=(1, 64, 96, c)).astype(
        np.float32)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(img))
    jvars = jbackbone.load_torch_resnet_state(
        {"params": variables["params"], "frozen": variables["frozen"]}, path)
    port = backbone.ResNet50(torch.Generator().manual_seed(0),
                             depth_input=depth_input)
    fresh = port.conv1.weight.detach().clone()
    backbone.load_torch_resnet_state(port, path)
    sd = torch.load(path, weights_only=True)
    if depth_input:
        assert torch.equal(port.conv1.weight, fresh)
        with torch.no_grad():
            port.conv1.weight.copy_(torch.from_numpy(np.array(
                jvars["params"]["conv1"]["kernel"]).transpose(3, 2, 0, 1)))
    else:
        assert torch.equal(port.conv1.weight, sd["conv1.weight"])
    assert torch.equal(port.layer3_2.bn2.mean, sd["layer3.2.bn2.running_mean"])
    assert torch.equal(port.layer4_0.down_bn.var,
                       sd["layer4.0.downsample.1.running_var"])
    with torch.no_grad():
        got = port(torch.from_numpy(img).permute(0, 3, 1, 2))
    want = jmodel.apply(jvars, jnp.asarray(img))
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        err, scale = float(np.abs(g.numpy() - w).max()), float(
            np.abs(w).max())
        print(json.dumps({"resnet50_import": list(w.shape), "err": err,
                          "scale": scale}))
        assert scale > 0.1 and err <= 2e-5 * scale


def test_resnet_import_refuses_a_wrong_shape(tmp_path):
    path = str(tmp_path / "resnet50.pth")
    hfc.write_seeded_resnet50(path)
    sd = torch.load(path, weights_only=True)
    sd["layer2.1.conv2.weight"] = sd["layer2.1.conv2.weight"][:, :-1]
    torch.save(sd, path)
    port = backbone.ResNet50(torch.Generator().manual_seed(0))
    before = port.conv1.weight.detach().clone()
    with pytest.raises(ValueError, match="layer2.1.conv2"):
        backbone.load_torch_resnet_state(port, path)
    assert torch.equal(port.conv1.weight, before)


def test_tracker_import_equals_jax():
    from test_vit_tracker_parity import CFG, _TorchTracker

    torch.manual_seed(0)
    tm = _TorchTracker(CFG).eval()
    want = zoo.flatten_params(jvt.import_torch_tracker(tm.state_dict(), CFG))
    cfg = vt.ViTTrackerConfig(**{f.name: getattr(CFG, f.name)
                                 for f in dataclasses.fields(CFG)})
    tree = vt.import_torch_tracker(tm.state_dict(), cfg)
    got = zoo.flatten_params(tree)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    load_zoo_params(vt.ViTTracker(cfg, device="cpu"), tree)
