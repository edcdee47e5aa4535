"""The port's Swin trunk and Mask2Former (``models/swin.py``,
``models/mask2former.py``) and its mask backend (``sowa/masks.py``
``Mask2FormerBackend``) against the JAX package's, on the CPU.

The same weights on both sides: the port's seeded weights exported with
``convert.zoo_params`` feed the JAX functions.  The pixel decoder's MSDA is
the port's plain version here (CPU tensors) and the JAX package's XLA
path there.  Tiny widths: Swin embed 16, depths (1, 1, 2, 1), window 4 on
64 x 100 and 64 x 96 inputs (16 x 25 at stage 1: padded windows and odd
merges), hidden 32, 2 encoder and 4 decoder layers, 2 heads, 10 queries.

Tolerances (ROADMAP's transformer layers: 2e-4 to 3e-4): trunk maps and
pixel-decoder outputs 2e-5 of their magnitude (measured 6e-7); class and
mask logits, layer by layer and whole, 1e-5 of their magnitude (measured
2e-7).  The decoder's attention masks are ``sigmoid < 0.5`` of resized
logits: an entry may flip only where the logit is within 1e-5 of its
magnitude of 0, and each comparison reports how many flipped.  The
backend's written masks may differ only where the resized logit is that
close to 0."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monosowa_tpu.models import mask2former as jm2f
from monosowa_tpu.models import swin as jswin
from monosowa_tpu.sowa import masks as jmasks
from monosowa_tpu_torch.convert import load_zoo_params, zoo_params
from monosowa_tpu_torch.models import mask2former as m2f
from monosowa_tpu_torch.models import swin
from monosowa_tpu_torch.sowa import masks

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(1)    # the suite runs six worker processes at once

SWIN = swin.SwinConfig(embed_dim=16, depths=(1, 1, 2, 1),
                       num_heads=(1, 2, 4, 8), window_size=4)
CFG = m2f.Mask2FormerConfig(
    backbone=SWIN, feature_size=32, mask_feature_size=32, hidden_dim=32,
    encoder_layers=2, decoder_layers=4, num_attention_heads=2,
    encoder_feedforward_dim=64, dim_feedforward=64, num_queries=10,
    num_labels=5)
FEATURE_TOL, LOGIT_TOL = 2e-5, 1e-5


def jax_config(cfg):
    bb = jswin.SwinConfig(**dataclass_dict(cfg.backbone))
    return jm2f.Mask2FormerConfig(
        backbone=bb, **{k: v for k, v in dataclass_dict(cfg).items()
                        if k != "backbone"})


def dataclass_dict(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


@pytest.fixture(scope="module")
def model():
    mod = m2f.Mask2Former(CFG, device="cpu", seed=0)
    return mod, zoo_params(mod)


def _pixels(h, w, seed=0):
    return np.random.default_rng(seed).normal(size=(1, h, w, 3)).astype(
        np.float32)


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    print(json.dumps({what: err, "scale": scale}))
    assert got.shape == want.shape and err <= tol * scale, (what, err, scale)


@pytest.mark.parametrize("hw", [(64, 100), (64, 96)])
def test_swin_trunk_matches_jax(model, hw):
    mod, tree = model
    x = _pixels(*hw)
    with torch.no_grad():
        got = mod.backbone(torch.from_numpy(x))
    want = jswin.swin_backbone(tree["backbone"], jnp.asarray(x),
                               jax_config(CFG).backbone)
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g.numpy(), w, FEATURE_TOL, f"swin_stage{i + 1}")


def test_swin_rel_index_and_shift_mask_equal_jax():
    for w in (4, 7, 12):
        np.testing.assert_array_equal(swin._rel_index(w),
                                      jswin._rel_index(w))
    for hp, wp, w, s in ((8, 12, 4, 2), (96, 324, 12, 6), (12, 12, 12, 6)):
        np.testing.assert_array_equal(swin._shift_mask(hp, wp, w, s),
                                      jswin._shift_mask(hp, wp, w, s))


def _jax_features(tree, x):
    return jswin.swin_backbone(tree["backbone"], jnp.asarray(x),
                               jax_config(CFG).backbone)


def test_pixel_decoder_matches_jax(model):
    mod, tree = model
    feats = _jax_features(tree, _pixels(64, 100))
    with torch.no_grad():
        mf, ms = mod.pixel_decoder([torch.from_numpy(np.array(f))
                                    for f in feats])
    jmf, jms = jm2f.pixel_decoder(tree["pixel_decoder"], feats,
                                  jax_config(CFG))
    _close(mf.numpy(), jmf, FEATURE_TOL, "mask_features")
    for i, (g, w) in enumerate(zip(ms, jms)):
        _close(g.numpy(), w, FEATURE_TOL, f"multi_scale{i}")
    np.testing.assert_array_equal(m2f._sine_pos(12, 40, 16),
                                  jm2f._sine_pos(12, 40, 16))
    shapes = ((12, 40), (6, 20), (3, 10))
    np.testing.assert_array_equal(m2f._reference_points(shapes),
                                  jm2f._reference_points(shapes))


def _jax_layer(lp, hidden, qpe, enc, pos, att, heads):
    """One step of the JAX package's ``transformer_module`` loop, from its
    own building blocks."""
    full = att.sum(-1) == att.shape[-1]
    att = att & ~full[..., None]
    y = jm2f._mha(lp["cross_attn"], hidden + qpe, enc + pos, enc, heads,
                  mask=att)
    hidden = jm2f._ln(hidden + y, lp["cross_attn_layer_norm"])
    y = jm2f._self_attn(lp["self_attn"], hidden, qpe, heads)
    hidden = jm2f._ln(hidden + y, lp["self_attn_layer_norm"])
    y = jnp.maximum(hidden @ lp["fc1"]["kernel"] + lp["fc1"]["bias"], 0)
    y = y @ lp["fc2"]["kernel"] + lp["fc2"]["bias"]
    return jm2f._ln(hidden + y, lp["final_layer_norm"])


def _jax_predict(tp, hidden, mask_features, hw, heads):
    inter = jm2f._ln(hidden, tp["decoder_norm"])
    cls = inter @ tp["class_predictor"]["kernel"] \
        + tp["class_predictor"]["bias"]
    masks, att = jm2f._mask_predictor(tp["mask_predictor"], inter,
                                      mask_features, hw, heads)
    return cls, masks, att


def _att_logits(masks, hw):
    """The resized mask logits that the attention masks threshold."""
    r = np.asarray(jm2f.resize_bilinear_torch(
        jnp.asarray(masks).transpose(0, 2, 3, 1), hw))
    return r.transpose(0, 3, 1, 2).reshape(r.shape[0], r.shape[3], -1)


def _flips(att_port, att_jax, logits, heads):
    """Entries where the two attention masks differ; each must sit within
    LOGIT_TOL of its magnitude of 0."""
    a = np.asarray(att_port).reshape(-1, heads, *logits.shape[1:])
    b = np.asarray(att_jax).reshape(a.shape)
    diff = a != b
    if diff.any():
        near = np.abs(logits)[:, None].repeat(heads, 1)[diff]
        assert near.max() <= LOGIT_TOL * np.abs(logits).max()
    return int(diff.sum())


def test_decoder_layers_match_jax_layer_by_layer(model):
    """Each decoder layer and prediction of the port from the JAX state
    before it (hidden, attention mask): no layer inherits another's
    flips."""
    mod, tree = model
    jcfg = jax_config(CFG)
    heads = CFG.num_attention_heads
    feats = _jax_features(tree, _pixels(64, 100, seed=1))
    mf, ms = jm2f.pixel_decoder(tree["pixel_decoder"], feats, jcfg)
    tp = tree["transformer"]
    sizes = [(f.shape[1], f.shape[2]) for f in ms]
    pos = [jnp.asarray(jm2f._sine_pos(h, w, CFG.hidden_dim // 2)).reshape(
        1, -1, CFG.hidden_dim) for h, w in sizes]
    enc = [f.reshape(1, -1, CFG.hidden_dim) + tp["level_embed"][i]
           for i, f in enumerate(ms)]
    qpe = jnp.asarray(tp["queries_embedder"])[None]
    hidden = jnp.asarray(tp["queries_features"])[None]
    t = lambda a: torch.from_numpy(np.array(a))      # noqa: E731
    tm = mod.transformer
    flips = []
    want_cls, want_masks = jm2f.transformer_module(tp, ms, mf, jcfg)
    with torch.no_grad():
        cls, masks, att = _jax_predict(tp, hidden, mf, sizes[0], heads)
        c_p, m_p, a_p = tm.predict(t(hidden), t(mf), sizes[0])
        _close(c_p.numpy(), cls, LOGIT_TOL, "class_logits_0")
        _close(m_p.numpy(), masks, LOGIT_TOL, "mask_logits_0")
        flips.append(_flips(a_p, att, _att_logits(masks, sizes[0]), heads))
        for idx, layer in enumerate(tm.decoder_layers):
            li = idx % CFG.num_feature_levels
            nxt = _jax_layer(tp["decoder_layers"][idx], hidden, qpe,
                             enc[li], pos[li], att, heads)
            got = layer(t(hidden), t(qpe), t(enc[li]), t(pos[li]), t(att))
            _close(got.numpy(), nxt, FEATURE_TOL, f"decoder_layer{idx}")
            hidden = nxt
            hw = sizes[(idx + 1) % CFG.num_feature_levels]
            cls, masks, att = _jax_predict(tp, hidden, mf, hw, heads)
            c_p, m_p, a_p = tm.predict(t(hidden), t(mf), hw)
            _close(c_p.numpy(), cls, LOGIT_TOL, f"class_logits_{idx + 1}")
            _close(m_p.numpy(), masks, LOGIT_TOL, f"mask_logits_{idx + 1}")
            flips.append(_flips(a_p, att, _att_logits(masks, hw), heads))
            # the test's JAX step is the JAX package's loop
            np.testing.assert_array_equal(np.asarray(cls),
                                          np.asarray(want_cls[idx + 1]))
    print(json.dumps({"attention_mask_flips_by_layer": flips}))


def test_forward_matches_jax(model):
    """The whole forward, each side on its own attention masks; the flipped
    entries between them are counted."""
    mod, tree = model
    x = _pixels(64, 100, seed=2)
    with torch.no_grad():
        feats = mod.backbone(torch.from_numpy(x))
        mf, ms = mod.pixel_decoder(feats)
        classes, mks = mod.transformer(ms, mf)
        cls, msk = mod(torch.from_numpy(x))
    jcfg = jax_config(CFG)
    jfeats = _jax_features(tree, x)
    jmf, jms = jm2f.pixel_decoder(tree["pixel_decoder"], jfeats, jcfg)
    jclasses, jmks = jm2f.transformer_module(tree["transformer"], jms, jmf,
                                             jcfg)
    jcls, jmsk = jm2f.mask2former_forward(tree, jnp.asarray(x), jcfg)
    np.testing.assert_array_equal(cls.numpy(), classes[-1].numpy())
    np.testing.assert_array_equal(np.asarray(jcls), np.asarray(jclasses[-1]))
    sizes = [(f.shape[1], f.shape[2]) for f in jms]
    flips = 0
    for i in range(len(classes) - 1):
        hw = sizes[i % CFG.num_feature_levels]
        lp, lj = _att_logits(mks[i].numpy(), hw), _att_logits(jmks[i], hw)
        flips += int(((lp > 0) != (lj > 0)).sum())
    print(json.dumps({"forward_attention_mask_flips": flips}))
    _close(cls.numpy(), jcls, LOGIT_TOL, "class_logits")
    _close(msk.numpy(), jmsk, LOGIT_TOL, "mask_logits")
    assert cls.shape == (1, CFG.num_queries, CFG.num_labels + 1)
    assert msk.shape == (1, CFG.num_queries, 16, 25)


def test_zoo_tree_round_trip_and_mismatch_raises(model):
    mod, tree = model
    other = load_zoo_params(m2f.Mask2Former(CFG, device="cpu", seed=1), tree)
    for (name, a), (_, b) in zip(mod.state_dict().items(),
                                 other.state_dict().items()):
        assert torch.equal(a, b), name
    bad = dict(tree, pixel_decoder=dict(tree["pixel_decoder"],
                                        extra=np.zeros(3, np.float32)))
    with pytest.raises(ValueError, match="extra"):
        load_zoo_params(m2f.Mask2Former(CFG, device="cpu"), bad)
    small = m2f.Mask2FormerConfig(**dict(dataclass_dict(CFG),
                                         num_queries=8))
    with pytest.raises(ValueError, match="shape"):
        load_zoo_params(m2f.Mask2Former(small, device="cpu"), tree)


def car_bias(tree, cfg, image, input_hw, label=2, quantile=0.5,
             target=0.7):
    """A class bias for ``label`` with which the given quantile of the
    queries reaches P(label) ``target`` on ``image`` (a weight choice;
    random weights give every query about 1 / (labels + 1))."""
    jcfg = jax_config(cfg)
    x = jmasks.FlaxMask2FormerBackend(tree, jcfg, input_hw=input_hw)._encode(
        image)[None]
    logits = np.asarray(jm2f.mask2former_forward(tree, jnp.asarray(x),
                                                 jcfg)[0][0], np.float64)
    others = np.delete(logits, label, -1)
    lse = np.log(np.exp(others).sum(-1))
    need = np.log(target / (1 - target)) + lse - logits[:, label]
    return float(np.quantile(need, quantile))


def test_mask_backend_matches_jax(model):
    """``Mask2FormerBackend`` against ``FlaxMask2FormerBackend`` on one
    seeded 94 x 310 frame: the encoded image equal (cv2's INTER_LINEAR
    byte for byte), the same queries kept with the same scores for two
    label groups, masks equal pixel for pixel except where the resized
    logit is within LOGIT_TOL of its magnitude of 0."""
    mod, tree = model
    img = np.random.default_rng(5).integers(0, 256, (94, 310, 3), np.uint8)
    hw = (64, 96)
    tree = dict(tree, transformer=dict(tree["transformer"]))
    tree["transformer"]["class_predictor"] = dict(
        tree["transformer"]["class_predictor"])
    bias = tree["transformer"]["class_predictor"]["bias"].copy()
    bias[2] += car_bias(tree, CFG, img, hw)
    tree["transformer"]["class_predictor"]["bias"] = bias
    port = masks.Mask2FormerBackend(tree, CFG, input_hw=hw, device="cpu")
    ref = jmasks.FlaxMask2FormerBackend(tree, jax_config(CFG), input_hw=hw)
    np.testing.assert_array_equal(port._encode(img).numpy(),
                                  ref._encode(img))
    groups = [port.car_label_ids, (0, 3)]
    got = port.predict_masks_multi(img, groups)
    want = ref.predict_masks_multi(img, groups)
    # the JAX backend's mask logits at the image's size, per kept query
    classes, logits = ref._fwd(jnp.asarray(ref._encode(img)[None]))
    probs = np.asarray(jax.nn.softmax(classes[0], -1))[:, :-1]
    logits = np.asarray(logits[0])
    bar = LOGIT_TOL * np.abs(logits).max()
    n_kept, n_flip = [], 0
    for ids, (gm, gs), (wm, ws) in zip(groups, got, want):
        np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-6)
        assert len(gm) == len(wm)
        n_kept.append(len(gm))
        kept = [q for q in np.flatnonzero(probs[:, list(ids)].max(-1) > 0.7)
                if (cv2.resize(logits[q], (310, 94)) > 0).any()]
        for q, a, b in zip(kept, gm, wm):
            full = cv2.resize(logits[q], (310, 94),
                              interpolation=cv2.INTER_LINEAR)
            np.testing.assert_array_equal(b, full > 0)
            n_flip += int((a != b).sum())
            assert (np.abs(full[a != b]) <= bar).all()
    assert 0 < n_kept[0] < CFG.num_queries
    assert (port.predict_masks(img)[0] == got[0][0][0]).all()
    print(json.dumps({"kept": n_kept, "mask_pixel_flips": n_flip}))
    assert port.score_threshold == ref.score_threshold == 0.7
    assert port.input_hw == ref.input_hw
