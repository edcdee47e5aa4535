"""The port's ViT tracker (``models/vit_tracker.py``) and its tracking
backend (``sowa/tracker2d.py`` ``ViTTrackerBackend``) against the JAX
package's, on the CPU.

The weights: the JAX package's ``init_tracker_params`` layout, with every
kernel at unit gain (std 1 / sqrt(fan in)), biases N(0, 0.1), norm scales
1 + N(0, 0.1) and the raw tables N(0, 0.5) (at the initialiser's 0.02
every token looks alike), handed to the port by ``convert.
load_zoo_params``.  Tolerances: box, score map and track tokens within
2e-5 of their magnitude; through ``track_masks`` (several frames, each
step's crop from the last box) the boxes within 1e-3 pixels and the
matched detection ids equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monosowa_tpu.models import vit_tracker as jvt
from monosowa_tpu.sowa import tracker2d as jtr
from monosowa_tpu_torch.convert import load_zoo_params, zoo_params
from monosowa_tpu_torch.models import vit_tracker as vt
from monosowa_tpu_torch.sowa import tracker2d

pytest.importorskip("cv2")
torch.set_num_threads(1)    # the suite runs six worker processes at once

TOL = 2e-5
SMALL = dict(hidden_size=32, num_layers=2, num_heads=2, patch_size=16,
             template_size=32, search_size=64, num_track_tokens=2)


def random_tree(tree, seed=0):
    rng = np.random.default_rng(seed)

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        shape = np.shape(node)
        if key == "kernel":
            v = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        elif key == "scale":
            v = 1.0 + 0.1 * rng.normal(size=shape)
        elif key == "bias":
            v = 0.1 * rng.normal(size=shape)
        else:
            v = 0.5 * rng.normal(size=shape)
        return v.astype(np.float32)

    return walk(tree)


@pytest.fixture(scope="module")
def setup():
    jcfg = jvt.ViTTrackerConfig(**SMALL)
    cfg = vt.ViTTrackerConfig(**SMALL)
    params = random_tree(jvt.init_tracker_params(0, jcfg))
    model = load_zoo_params(vt.ViTTracker(cfg), params)
    return jcfg, cfg, params, model


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_layout_is_the_jax_init_layout(setup):
    from monosowa_tpu_torch.sowa.zoo import flatten_params

    jcfg, cfg, params, _ = setup
    want = flatten_params(jvt.init_tracker_params(1, jcfg))
    got = flatten_params(zoo_params(vt.ViTTracker(cfg, seed=1)))
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}


def test_tracker_forward(setup):
    jcfg, cfg, params, model = setup
    rng = np.random.default_rng(2)
    z = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    tok = rng.normal(size=(2, 2, 32)).astype(np.float32)
    want = jvt.tracker_forward(params, jnp.asarray(z), jnp.asarray(x),
                               jnp.asarray(tok), jcfg)
    with torch.no_grad():
        got = model(torch.from_numpy(z), torch.from_numpy(x),
                    torch.from_numpy(tok))
    for g, w in zip(got, want):
        assert rel(g.numpy(), w) < TOL
    # each stage on its own: the embedding and one block
    with torch.no_grad():
        emb = model.embed(torch.from_numpy(x))
        blk = model.block_0(torch.from_numpy(tok))
    assert rel(emb.numpy(), jvt._embed(params["patch_proj"], jnp.asarray(x),
                                       jcfg)) < TOL
    assert rel(blk.numpy(), jvt._block(params["block_0"], jnp.asarray(tok),
                                       jcfg)) < TOL


def moving_square_frames(n=5, hw=(120, 200)):
    rng = np.random.default_rng(3)
    frames, boxes = [], []
    for f in range(n):
        img = rng.integers(0, 40, hw + (3,), dtype=np.uint8)
        x0, y0 = 40 + 7 * f, 50
        img[y0:y0 + 20, x0:x0 + 30] = [230, 180, 90]
        frames.append(img)
        boxes.append([np.array([x0, y0, x0 + 30, y0 + 20], float),
                      np.array([150, 10, 170, 30], float)])
    return frames, boxes


def test_track_masks_through_both_backends(setup):
    jcfg, cfg, params, _ = setup
    frames, boxes = moving_square_frames()
    jproto = jtr.FlaxViTTrackerBackend(params, jcfg)
    tproto = tracker2d.ViTTrackerBackend(params, cfg, device="cpu")

    def fresh(proto):
        def make():
            import copy
            t = copy.copy(proto)
            t._template = t._track_tokens = t._box = None
            return t
        return make

    # the crops: OpenCV's uint8 resize, byte for byte
    want = jproto._crop(frames[0], 55.0, 60.0, 61.3, 64)
    got = tproto._crop(torch.from_numpy(frames[0]), 55.0, 60.0, 61.3, 64)
    np.testing.assert_array_equal(got.numpy(), want)
    init = [np.array([40, 50, 70, 70], float),
            np.array([100, 20, 140, 60], float)]
    jt = jtr.track_masks(frames, init, boxes, fresh(jproto))
    tt = tracker2d.track_masks(frames, init, boxes, fresh(tproto))
    for a, b in zip(tt, jt):
        assert a.matched_mask_idx == b.matched_mask_idx
        for ba, bb in zip(a.boxes, b.boxes):
            np.testing.assert_allclose(ba, bb, atol=1e-3)
