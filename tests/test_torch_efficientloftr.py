"""The port's EfficientLoFTR (``models/efficientloftr.py``) and its
stitching backend (``sowa/stitching.py`` ``LoFTRMatcherBackend``) against
the JAX package's, on the CPU.

The weights: a seeded ``transformers.EfficientLoFTRForKeypointMatching``
at ``tests/test_efficientloftr_parity.py``'s tiny config, imported by the
JAX package's ``import_hf_efficientloftr`` (BatchNorms folded), then handed
to the port through ``convert.load_zoo_params``.  Tolerances: backbone and
transformer features within 2e-5 of their magnitude; the coarse matches
equal (a score near the threshold or a mutual-nearest tie may flip between
two float32 computations: the flips are printed, 0 so far); keypoints
within 1e-5 of the image size; the backend's (src, dst) pairs equal in
count and within 1e-5 x 130 pixels."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monosowa_tpu.models import efficientloftr as jelo
from monosowa_tpu.sowa import stitching as jstitch
from monosowa_tpu_torch.convert import load_zoo_params, zoo_params
from monosowa_tpu_torch.models import efficientloftr as elo
from monosowa_tpu_torch.sowa import stitching

transformers = pytest.importorskip("transformers")
pytest.importorskip("cv2")
torch.set_num_threads(1)    # the suite runs six worker processes at once

TOL = 2e-5


def tiny_hf_config():
    return transformers.EfficientLoFTRConfig(
        stage_num_blocks=[1, 1, 1, 1], out_features=[4, 8, 16, 32],
        stage_stride=[2, 1, 2, 2], hidden_size=32, num_attention_heads=2,
        num_attention_layers=2, partial_rotary_factor=1.0,
        fine_kernel_size=8, fine_matching_slice_dim=4,
        coarse_matching_threshold=1e-6)


@pytest.fixture(scope="module")
def setup():
    hf_cfg = tiny_hf_config()
    torch.manual_seed(0)
    stock = transformers.EfficientLoFTRForKeypointMatching(hf_cfg).eval()
    jcfg = jelo.config_from_hf_efficientloftr(hf_cfg)
    params = jelo.import_hf_efficientloftr(stock.state_dict(), jcfg)
    cfg = elo.config_from_hf_efficientloftr(hf_cfg)
    model = load_zoo_params(elo.EfficientLoFTR(cfg), params)
    gray = np.random.default_rng(1).uniform(size=(1, 2, 64, 64)).astype(
        np.float32)
    return jcfg, params, cfg, model, gray


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_backbone_and_transformer(setup):
    jcfg, params, cfg, model, gray = setup
    x = gray.reshape(2, 64, 64, 1)
    jf = jelo.repvgg_forward(params["backbone"], jnp.asarray(x), jcfg)
    with torch.no_grad():
        tf = model.repvgg_forward(torch.from_numpy(x))
    for j, t in zip(jf, tf):
        assert rel(t.numpy(), j) < TOL
    ch = jf[-1].shape[1]
    ah = (ch - jcfg.q_aggregation_kernel_size) \
        // jcfg.q_aggregation_stride + 1
    cos, sin = jelo._rope_tables(jcfg, ah, ah)
    tcos, tsin = elo.rope_tables(cfg, ah, ah)
    np.testing.assert_array_equal(tcos, cos)
    np.testing.assert_array_equal(tsin, sin)
    coarse = np.array(jf[-1]).reshape(1, 2, ch, ch, -1)
    want = jelo.local_feature_transformer(
        params["transformer"], jnp.asarray(coarse),
        (jnp.asarray(cos), jnp.asarray(sin)), jcfg)
    with torch.no_grad():
        got = model.local_feature_transformer(
            torch.from_numpy(coarse), model.rope(ah, ah, "cpu"))
    assert rel(got.numpy(), want) < TOL
    # the fine fusion's windows from the same transformer output
    c = (np.asarray(want).reshape(2, ch, ch, -1)
         / np.float32(np.sqrt(cfg.hidden_size)))
    res = [np.asarray(jf[1]), np.asarray(jf[0])]
    w0, w1 = jelo.fine_fusion(params["fine_fusion"], jnp.asarray(c),
                              [jnp.asarray(r) for r in res], jcfg)
    with torch.no_grad():
        t0, t1 = model.fine_fusion_forward(
            torch.from_numpy(c), [torch.from_numpy(r) for r in res])
    assert rel(t0.numpy(), w0) < TOL and rel(t1.numpy(), w1) < TOL


def test_match_pair(setup):
    jcfg, params, cfg, model, gray = setup
    kp, sc, idx = jelo.match_pair(params, jnp.asarray(gray), jcfg)
    with torch.no_grad():
        tkp, tsc, tidx = model(torch.from_numpy(gray))
    flips = int((tidx.numpy() != np.asarray(idx)).sum())
    print(json.dumps({"loftr_match_flips": flips,
                      "matched": int((np.asarray(idx) >= 0).sum())}))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    assert (np.asarray(idx) >= 0).sum() > 0
    assert rel(tsc.numpy(), sc) < TOL
    m = np.asarray(idx) >= 0
    np.testing.assert_allclose(tkp.numpy()[m], np.asarray(kp)[m], atol=1e-5)


def test_fine_matching_alone(setup):
    """The two fine stages on the same gathered windows (random windows,
    so every argmax is far from a tie)."""
    jcfg, _, cfg, model, _ = setup
    rng = np.random.default_rng(4)
    k, d = cfg.fine_kernel_size, 16
    f0 = rng.normal(size=(1, 20, k * k, d)).astype(np.float32)
    f1 = rng.normal(size=(1, 20, (k + 2) ** 2, d)).astype(np.float32)
    kp = rng.uniform(0, 64, (1, 2, 20, 2)).astype(np.float32)
    want = jelo._fine_matching(jnp.asarray(f0), jnp.asarray(f1),
                               jnp.asarray(kp), 2.0, jcfg)
    with torch.no_grad():
        got = model.fine_matching(torch.from_numpy(f0), torch.from_numpy(f1),
                                  torch.from_numpy(kp), 2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_matcher_backend(setup):
    jcfg, params, cfg, model, _ = setup
    rng = np.random.default_rng(3)
    img_a = rng.integers(0, 255, (100, 130, 3), dtype=np.uint8)
    img_b = rng.integers(0, 255, (100, 130, 3), dtype=np.uint8)
    jb = jstitch.FlaxLoFTRMatcherBackend(params, jcfg, input_hw=(64, 64),
                                         min_confidence=1e-6)
    tb = stitching.LoFTRMatcherBackend(params, cfg, input_hw=(64, 64),
                                       min_confidence=1e-6, device="cpu")
    # the encode: OpenCV's grey and area resize, byte for byte
    for im in (img_a, img_b):
        np.testing.assert_array_equal(tb._gray(im).numpy(), jb._gray(im))
    src, dst = tb.match(img_a, img_b)
    jsrc, jdst = jb.match(img_a, img_b)
    assert len(src) == len(jsrc) >= 4
    np.testing.assert_allclose(src, jsrc, atol=130e-5)
    np.testing.assert_allclose(dst, jdst, atol=130e-5)


def test_zoo_tree_round_trip(setup):
    """The port's seeded full-layout tree is the JAX import's layout: the
    same keys and shapes, and it loads back unchanged."""
    _, params, cfg, model, _ = setup
    from monosowa_tpu_torch.sowa.zoo import flatten_params

    seeded = zoo_params(elo.EfficientLoFTR(cfg, seed=5))
    a, b = flatten_params(seeded), flatten_params(params)
    assert {k: v.shape for k, v in a.items()} == \
        {k: np.shape(v) for k, v in b.items()}
    again = zoo_params(load_zoo_params(elo.EfficientLoFTR(cfg), seeded))
    for k, v in flatten_params(again).items():
        np.testing.assert_array_equal(v, a[k])

