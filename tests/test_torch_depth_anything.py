"""The port's DINOv2 and Depth Anything (``models/dinov2.py``,
``models/depth_anything.py``) and its depth backend (``sowa/depth.py``
``DepthAnythingBackend``) against the JAX package's, on the CPU.

The same weights on both sides: a JAX tree from
``init_depth_anything_params`` with its kernels rescaled to unit gain
(std 1 / sqrt(fan in); the tree's 0.02 would leave the head at sigmoid(0))
and its biases and norm scales drawn, loaded into the port with
``convert.load_zoo_params``.  Tiny widths: hidden 32, 2 layers, 4 heads, a
5 x 5 position grid resampled to the patch grid (plain bicubic, and the
antialiased one of the with-registers variant), the GELU and the SwiGLU
FFN.

Tolerances (ROADMAP's transformer layers: 2e-4 to 3e-4): trunk features
2e-5 of their magnitude (measured 7e-7); depth 2e-5 of ``max_depth``
(measured 1.6e-6).  The backend's encoded image is cv2's INTER_CUBIC within
one uint8 step (``tests/test_torch_resize.py``); its depth is compared with
the JAX network on the port's encoding (2e-5 of ``max_depth``) and with the
JAX backend end to end (1e-3 of ``max_depth``, measured 5.7e-5: a value
one uint8 step off moves the depth near it)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monosowa_tpu.models import depth_anything as jda
from monosowa_tpu.models import dinov2 as jdino
from monosowa_tpu.ops import resize as jresize
from monosowa_tpu.sowa import depth as jdepth
from monosowa_tpu_torch.convert import load_zoo_params, zoo_params
from monosowa_tpu_torch.models import depth_anything as da
from monosowa_tpu_torch.models import dinov2
from monosowa_tpu_torch.sowa import depth

pytest.importorskip("cv2")
torch.set_num_threads(1)    # the suite runs six worker processes at once

TOL = 2e-5
VARIANTS = {"gelu": {}, "registers_aa": {"num_register_tokens": 2,
                                         "antialias_pos_interp": True},
            "swiglu": {"use_swiglu_ffn": True}}


def configs(variant="gelu", kind="metric"):
    bb = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
              pos_grid=5, **VARIANTS[variant])
    head = dict(out_indices=(1, 1, 2, 2), neck_hidden_sizes=(8, 16, 24, 32),
                fusion_hidden_size=16, head_hidden_size=8,
                depth_estimation_type=kind, max_depth=80.0)
    return (jda.DepthAnythingConfig(backbone=jdino.Dinov2Config(**bb),
                                    **head),
            da.DepthAnythingConfig(backbone=dinov2.Dinov2Config(**bb),
                                   **head))


def unit_gain(tree, seed=0):
    """The tree with each kernel at std 1 / sqrt(fan in), biases drawn
    (std 0.1) and norm scales 1 + N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        a = np.asarray(node, np.float32)
        if key == "kernel":
            return (a / a.std() / np.sqrt(np.prod(a.shape[:-1]))).astype(
                np.float32)
        if key == "bias":
            return rng.normal(0, 0.1, a.shape).astype(np.float32)
        if key == "scale":
            return (1 + rng.normal(0, 0.1, a.shape)).astype(np.float32)
        return a
    return walk(tree)


@pytest.fixture(scope="module", params=list(VARIANTS))
def nets(request):
    jcfg, cfg = configs(request.param)
    tree = unit_gain(jda.init_depth_anything_params(0, jcfg))
    return jcfg, cfg, tree, load_zoo_params(da.DepthAnything(cfg,
                                                             device="cpu"),
                                            tree)


def _pixels(h, w, seed=0):
    return np.random.default_rng(seed).normal(size=(1, h, w, 3)).astype(
        np.float32)


def _close(got, want, tol, scale, what):
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    print(json.dumps({what: err, "scale": scale}))
    assert np.shape(got) == np.shape(want) and err <= tol * scale


@pytest.mark.parametrize("hw", [(70, 126), (70, 70)])
def test_dinov2_features_match_jax(nets, hw):
    """Hidden states 0..2 after the final norm; 70 x 70 is the 5 x 5 grid
    itself (no resampling)."""
    jcfg, _, tree, model = nets
    x = _pixels(*hw)
    with torch.no_grad():
        got = model.backbone.features(torch.from_numpy(x), (0, 1, 2))
        raw = model.backbone.features(torch.from_numpy(x), (2,), False)
    want = jdino.dinov2_features(tree["backbone"], jnp.asarray(x),
                                 jcfg.backbone, (0, 1, 2))
    wraw = jdino.dinov2_features(tree["backbone"], jnp.asarray(x),
                                 jcfg.backbone, (2,), False)
    for i, (g, w) in enumerate(zip(got + raw, want + wraw)):
        _close(g.numpy(), w, TOL, float(np.abs(w).max()), f"dinov2_{i}")


def test_depth_anything_forward_matches_jax(nets):
    jcfg, cfg, tree, model = nets
    x = _pixels(84, 126, seed=1)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = np.asarray(jda.depth_anything_forward(tree, jnp.asarray(x), jcfg))
    assert got.shape == (1, 84, 126)
    assert 0 <= got.min() and got.max() <= cfg.max_depth
    assert got.std() > 1.0          # the unit-gain weights reach the head
    _close(got, want, TOL, cfg.max_depth, "depth")


def test_relative_depth_and_round_trip():
    jcfg, cfg = configs("gelu", "relative")
    tree = unit_gain(jda.init_depth_anything_params(1, jcfg))
    model = load_zoo_params(da.DepthAnything(cfg, device="cpu"), tree)
    x = _pixels(56, 98, seed=2)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = np.asarray(jda.depth_anything_forward(tree, jnp.asarray(x), jcfg))
    _close(got, want, TOL, float(np.abs(want).max()), "relative_depth")
    back = zoo_params(model)
    from monosowa_tpu.sowa.zoo import flatten_params
    a, b = flatten_params(tree), flatten_params(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="metric"):
        depth.DepthAnythingBackend(tree, cfg, fx=721.5, device="cpu")


@pytest.fixture(scope="module")
def backends():
    jcfg, cfg = configs("gelu")
    tree = unit_gain(jda.init_depth_anything_params(3, jcfg))
    return (depth.DepthAnythingBackend(tree, cfg, fx=721.5, input_size=42,
                                       device="cpu"),
            jdepth.FlaxDepthAnythingBackend(tree, jcfg, fx=721.5,
                                            input_size=42), tree, jcfg)


def test_depth_backend_matches_jax(backends):
    port, ref, tree, jcfg = backends
    img = np.random.default_rng(4).integers(0, 256, (94, 310, 3), np.uint8)
    x, xr = port._encode(img).numpy(), ref._encode(img)
    assert x.shape == xr.shape == (42, 140, 3)
    step = (1 / 255) / np.asarray(port.IMAGENET01_STD, np.float32)
    off = np.abs(x - xr) > 1e-6
    assert (np.abs(x - xr) <= step + 1e-6).all() and off.mean() <= 1e-3
    # the network and the resize back on the port's encoding
    pred = jda.depth_anything_forward(tree, jnp.asarray(x[None]), jcfg)[0]
    want = np.maximum(np.asarray(jresize.resize_bicubic_torch(
        pred[..., None], img.shape[:2]))[..., 0], 0.0)
    got = port.predict_metric_depth(img)
    assert got.shape == (94, 310) and got.dtype == np.float32
    _close(got, want, TOL, 80.0, "backend_metric_depth")
    # end to end against the JAX backend
    e2e = ref.predict_metric_depth(img)
    print(json.dumps({"encoded_values_one_step_off": int(off.sum())}))
    _close(got, e2e, 1e-3, 80.0, "backend_vs_jax_backend")
    canon = port.predict_depth(img)
    np.testing.assert_allclose(canon, got * np.float32(1000.0 / 721.5),
                               rtol=1e-6)
    np.testing.assert_allclose(canon, ref.predict_depth(img), rtol=0,
                               atol=1e-3 * 80.0 * 1000.0 / 721.5)


def test_pseudo_lidar_cache_from_live_backend(backends, tmp_path):
    """``generate_pseudo_lidar_cache`` with the live backend (it raised
    before the zoo was ported): the JAX package's file, skip-if-exists."""
    port, ref, _, _ = backends
    rng = np.random.default_rng(6)
    imgs = [rng.integers(0, 256, (56, 120, 3), np.uint8) for _ in range(2)]
    p2 = np.array([[300.0, 0, 60, 0], [0, 300.0, 28, 0], [0, 0, 1, 0]])
    assert depth.generate_pseudo_lidar_cache(
        ["a", "b"], imgs, p2, str(tmp_path / "t"), backend=port,
        device="cpu") == 2
    assert depth.generate_pseudo_lidar_cache(
        ["a", "b"], imgs, p2, str(tmp_path / "t"), backend=port,
        device="cpu") == 0
    assert jdepth.generate_pseudo_lidar_cache(
        ["a", "b"], imgs, p2, str(tmp_path / "j"), backend=ref) == 2
    for f in ("a", "b"):
        got = depth.load_pseudo_lidar(str(tmp_path / "t" / f"{f}.npz"))
        want = jdepth.load_pseudo_lidar(str(tmp_path / "j" / f"{f}.npz"))
        assert got.shape == want.shape and got.shape[1] == 3
        # the points scale with depth: the end-to-end bar of the backend
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-3 * 80.0 * 1.5)
