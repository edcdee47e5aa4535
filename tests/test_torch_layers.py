"""The torch port's modules against their JAX counterparts, with the same
weights carried over by the weight bridge (``monosowa_tpu_torch.convert``).

Widths are those of tests/test_train_step.py (d_model 64, 4 heads) at a
96x160 image; inputs come from numpy.  The JAX modules run deterministic
(their default), the port's in eval mode.  Tolerance: 2e-4 of each output's
largest magnitude (the transformer bar of ROADMAP.md; random-init ResNet
activations grow, so the bar is relative).
"""

import jax
import numpy as np
import pytest
import torch

from monosowa_tpu.models.backbone import ResNet50 as JaxResNet50
from monosowa_tpu.models.depth_predictor import DepthPredictor as JaxDP
from monosowa_tpu.models.layers import MultiHeadAttention as JaxMHA
from monosowa_tpu.models.position_encoding import sine_position_encoding
from monosowa_tpu.models.transformer import (
    DepthAwareDecoderLayer as JaxDecoderLayer,
    VisualEncoderLayer as JaxEncoderLayer,
    encoder_reference_points)
from monosowa_tpu_torch.convert import load_flax_params
from monosowa_tpu_torch.models.backbone import ResNet50
from monosowa_tpu_torch.models.depth_predictor import DepthPredictor
from monosowa_tpu_torch.models.layers import MultiHeadAttention
from monosowa_tpu_torch.models.transformer import (DepthAwareDecoderLayer,
                                                   VisualEncoderLayer)

D, HEADS = 64, 4
# the 96x160 pyramid: strides 8, 16, 32, 64
SHAPES = ((12, 20), (6, 10), (3, 5), (2, 3))
S = sum(h * w for h, w in SHAPES)
TOL = 2e-4


def _gen():
    return torch.Generator().manual_seed(0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jitter(tree, rng, scale=0.05):
    """Perturb every parameter so zero-initialised heads take part."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.normal(size=a.shape).astype(
            np.float32), tree)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got / scale, want / scale, atol=TOL)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_resnet50_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.normal(size=(2, 96, 160, 3)).astype(np.float32)
    jm = JaxResNet50()
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), img[:1])
    # non-identity frozen BN statistics, so the scale/shift fold is tested
    frozen = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
        _np(v["frozen"]))
    want = jax.jit(jm.apply)({"params": v["params"], "frozen": frozen}, img)

    tm = ResNet50(_gen())
    load_flax_params(tm, _np(v["params"]), frozen)
    with torch.no_grad():
        got = tm(_t(img).permute(0, 3, 1, 2))
    assert len(got) == 3
    for g, w in zip(got, want):
        _close(g.permute(0, 2, 3, 1).numpy(), w)


def test_depth_predictor_matches_jax():
    """Includes the 2x bilinear upsample of the stride-32 map on a
    non-square (3x5 -> 6x10) grid."""
    rng = np.random.default_rng(1)
    feats = [rng.normal(size=(2, h, w, D)).astype(np.float32)
             for h, w in SHAPES[:3]]
    pos16 = sine_position_encoding(*SHAPES[1], D // 2)
    jm = JaxDP(d_model=D, num_depth_bins=16)
    v = jm.init(jax.random.PRNGKey(0), feats, pos16)
    want = jax.jit(lambda v, f: jm.apply(v, f, pos16))(v, feats)

    tm = DepthPredictor(_gen(), d_model=D, num_depth_bins=16).eval()
    load_flax_params(tm, _np(v["params"]))
    with torch.no_grad():
        got = tm([_t(f).permute(0, 3, 1, 2) for f in feats], _t(pos16))
    for g, w in zip(got, want):      # logits, embed, weighted depth, ip
        _close(g.numpy(), w)


def test_encoder_layer_matches_jax():
    rng = np.random.default_rng(2)
    src = rng.normal(size=(2, S, D)).astype(np.float32)
    pos = rng.normal(size=(2, S, D)).astype(np.float32)
    ref = np.broadcast_to(encoder_reference_points(SHAPES)[None],
                          (2, S, len(SHAPES), 2)).astype(np.float32)
    jm = JaxEncoderLayer(D, 64, 0.1, len(SHAPES), HEADS, 4, "xla")
    params = _jitter(jm.init(jax.random.PRNGKey(0), src, pos, ref,
                             SHAPES)["params"], rng)
    want = jm.apply({"params": params}, src, pos, ref, SHAPES)

    tm = VisualEncoderLayer(_gen(), D, 64, len(SHAPES), HEADS, 4).eval()
    load_flax_params(tm, params)
    with torch.no_grad():
        got = tm(_t(src), _t(pos), _t(ref), SHAPES)
    _close(got.numpy(), want)


@pytest.mark.parametrize("ref_dof", [2, 6])
def test_decoder_layer_matches_jax(ref_dof):
    """The inference branch: one query group, no denoising mask."""
    rng = np.random.default_rng(3)
    q = 10
    tgt = rng.normal(size=(2, q, D)).astype(np.float32)
    qpos = rng.normal(size=(2, q, D)).astype(np.float32)
    ref = rng.uniform(0.1, 0.9, (2, q, 1, ref_dof)).astype(np.float32)
    if ref_dof == 6:
        ref[..., 2:] *= 0.2
    ref = np.repeat(ref, len(SHAPES), 2)
    memory = rng.normal(size=(2, S, D)).astype(np.float32)
    depth_seq = rng.normal(size=(2, 60, D)).astype(np.float32)
    jm = JaxDecoderLayer(D, 64, 0.1, len(SHAPES), HEADS, 4, 1, "xla")
    args = (tgt, qpos, ref, memory, SHAPES, depth_seq)
    params = _jitter(jm.init(jax.random.PRNGKey(0), *args)["params"], rng)
    want = jm.apply({"params": params}, *args, training=False)

    tm = DepthAwareDecoderLayer(_gen(), D, 64, len(SHAPES), HEADS,
                                4).eval()
    load_flax_params(tm, params)
    with torch.no_grad():
        got = tm(_t(tgt), _t(qpos), _t(ref), _t(memory), SHAPES,
                 _t(depth_seq))
    _close(got.numpy(), want)


def test_multi_head_attention_matches_jax():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 7, D)).astype(np.float32)
    k = rng.normal(size=(2, 13, D)).astype(np.float32)
    v = rng.normal(size=(2, 13, D)).astype(np.float32)
    jm = JaxMHA(HEADS)
    params = jm.init(jax.random.PRNGKey(0), q, k, v)["params"]
    want = jm.apply({"params": params}, q, k, v)

    tm = MultiHeadAttention(D, HEADS, _gen())
    load_flax_params(tm, _np(params))
    with torch.no_grad():
        got = tm(_t(q), _t(k), _t(v))
    _close(got.numpy(), want)
