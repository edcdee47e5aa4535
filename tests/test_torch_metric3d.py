"""The port's Metric3D route (``sowa/depth.py``: ``encode_image``,
``metric3d_decode_lift``, ``compute_pseudo_lidar``,
``TorchHubMetric3DBackend``, and ``zoo.depth_backend``'s
``metric3d_hub``) against the JAX package's on the CPU.

No test touches the network: ``torch.hub.load`` is replaced by one seeded
stub model in both packages.  Images: KITTI's 375 x 1242 and 370 x 1226
(fractional scale, pads on both sides), a portrait 640 x 480 and a small
100 x 150 (the crop is resized down, where ``jax.image.resize``
antialiases).  Tolerances: the encoded uint8 image equal (the border value
is OpenCV's rounded [124, 116, 104]), float32 within 4e-6; decode, lift
and the backend's depth within 1e-5 of their magnitude."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monosowa_tpu.config import Config as JaxConfig
from monosowa_tpu.sowa import depth as jdepth
from monosowa_tpu.sowa import zoo as jzoo
from monosowa_tpu_torch.config import Config
from monosowa_tpu_torch.sowa import depth, zoo

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(1)    # the suite runs six worker processes at once

SIZES = [(375, 1242), (370, 1226), (640, 480), (100, 150)]
INTR = [721.5377, 721.5377, 609.5593, 172.854]
TOL = 1e-5


def image(h, w, seed, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    return rng.uniform(0, 255, (h, w, 3)).astype(np.float32)


def canonical_depth(seed, shape=(616, 1064)):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:shape[0], 0:shape[1]].astype(np.float32)
    return (30.0 + 20.0 * np.sin(x / 97.0 + rng.uniform(0, 6))
            * np.cos(y / 53.0 + rng.uniform(0, 6)) + 0.01 * y).astype(
                np.float32)


def close(got, want, what, tol=TOL):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    print(json.dumps({"metric3d": what, "max_abs_err": err,
                      "scale": scale}))
    assert err <= tol * scale, (what, err, scale)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("hw", SIZES)
def test_encode_image_matches_jax(hw, dtype):
    img = image(*hw, 11, dtype)
    chw, pad, intr, scale = depth.encode_image(img, INTR, device="cpu")
    jchw, jpad, jintr, jscale = jdepth.encode_image(img, INTR)
    assert pad == jpad and scale == jscale and intr == jintr
    assert chw.dtype == torch.float32 and chw.shape == (3, 616, 1064)
    if dtype == np.uint8:
        np.testing.assert_array_equal(chw.numpy(), jchw)
    else:
        np.testing.assert_allclose(chw.numpy(), jchw, rtol=0, atol=4e-6)


def test_encode_pads_with_the_rounded_mean():
    img = image(375, 1242, 3)
    chw, pad, _, _ = depth.encode_image(img, INTR, device="cpu")
    raw = chw.numpy() * np.float32(depth.IMAGENET_STD)[:, None, None] \
        + np.float32(depth.IMAGENET_MEAN)[:, None, None]
    assert pad[0] > 0
    np.testing.assert_allclose(raw[:, 0, 0], [124, 116, 104], atol=1e-4)


@pytest.mark.parametrize("hw", SIZES)
def test_decode_lift_matches_jax(hw):
    img = image(*hw, 5)
    _, pad, intr, _ = jdepth.encode_image(img, INTR)
    pred = canonical_depth(7)
    want_pts, want_metric = jdepth.metric3d_decode_lift(
        jnp.asarray(pred), tuple(pad), hw, jnp.float32(intr[0]),
        jnp.asarray(INTR, jnp.float32))
    pts, metric = depth.metric3d_decode_lift(
        torch.from_numpy(pred), pad, hw, torch.tensor(np.float32(intr[0])),
        torch.tensor(INTR, dtype=torch.float32))
    close(metric, want_metric, f"metric {hw}")
    close(pts, want_pts, f"points {hw}")


def stub_depth(chw):
    """A smooth function of the encoded image (numpy or torch)."""
    if torch.is_tensor(chw):
        return 25.0 + 10.0 * torch.tanh(chw.float().mean(0))
    return (25.0 + 10.0 * np.tanh(np.mean(np.asarray(chw, np.float32),
                                          axis=0))).astype(np.float32)


@pytest.mark.parametrize("hw", SIZES)
def test_compute_pseudo_lidar_matches_jax(hw):
    img = image(*hw, 31)
    want_pts, want_metric = jdepth.compute_pseudo_lidar(img, INTR,
                                                        stub_depth)
    pts, metric = depth.compute_pseudo_lidar(img, INTR, stub_depth,
                                             device="cpu")
    assert pts.dtype == metric.dtype == np.float32
    close(metric, want_metric, f"pseudo-lidar metric {hw}")
    close(pts, want_pts, f"pseudo-lidar points {hw}")


class StubMetric3D(torch.nn.Module):
    """torch.hub's Metric3D stand-in: ``inference`` returns (canonical
    depth (1, 1, 616, 1064), confidence, output dict)."""

    def __init__(self):
        super().__init__()
        self.gain = torch.nn.Parameter(torch.tensor(10.0))

    def inference(self, batch):
        x = batch["input"]
        d = 25.0 + self.gain * torch.tanh(x.float().mean(1, keepdim=True))
        return d, None, {}


@pytest.fixture
def hub(monkeypatch):
    calls = []

    def load(repo, name, **kw):
        calls.append((repo, name, kw))
        return StubMetric3D()

    monkeypatch.setattr(torch.hub, "load", load)
    return calls


@pytest.mark.parametrize("hw", SIZES[:3])
def test_hub_backend_matches_jax(hub, hw):
    img = image(*hw, 41)
    got = depth.TorchHubMetric3DBackend(device="cpu").predict_depth(img)
    want = jdepth.TorchHubMetric3DBackend().predict_depth(img)
    assert hub == [("yvanyin/metric3d", "metric3d_vit_giant2",
                    {"pretrain": True})] * 2
    assert got.dtype == np.float32
    close(got, want, f"hub backend {hw}")


def test_hub_backend_raises_offline(monkeypatch):
    def offline(*a, **k):
        raise OSError("no network")

    monkeypatch.setattr(torch.hub, "load", offline)
    with pytest.raises(RuntimeError, match="offline"):
        depth.TorchHubMetric3DBackend(device="cpu")
    with pytest.raises(RuntimeError, match="offline"):
        jdepth.TorchHubMetric3DBackend()


def test_zoo_dispatches_metric3d_hub(hub, tmp_path):
    """``backends.depth: metric3d_hub`` builds the hub backend with
    ``metric3d.model`` in both packages, and the CLI's lidar contract
    (``predict_depth`` with a settable ``fx``) holds."""
    raw = {"backends": {"depth": "metric3d_hub"},
           "metric3d": {"model": "metric3d_vit_large"}}
    got = zoo.depth_backend(Config(raw), str(tmp_path), device="cpu")
    want = jzoo.depth_backend(JaxConfig(raw), str(tmp_path))
    assert isinstance(got, depth.TorchHubMetric3DBackend)
    assert [c[1] for c in hub] == ["metric3d_vit_large"] * 2
    img = image(375, 1242, 2)
    got.fx = 721.5
    close(got.predict_depth(img), want.predict_depth(img), "zoo hub")
