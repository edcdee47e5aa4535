"""The device candidate extraction of the port (``sowa/candidates_device.py``)
against the JAX package's, on the same seeded numpy inputs, on the CPU.

Scenes: the JAX tests' 96 x 160 depth image (ground, car boxes at given
depths, ``tests/test_candidates_device.py``) and the same at a row width
that is no multiple of 8 (W = 150: 19 packed bytes, 2 padding bits).
Tolerances: the packed helpers bit for bit; the bisection medians equal;
``extract_frames_banked`` meta flags, counts and truncation equal, centres
within 2e-3 m (two bisection steps), valid bank points within 1e-5;
``extract_frames`` centres the same and member points equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from monosowa_tpu.sowa import candidates_device as J
from monosowa_tpu.sowa.candidates import CandidateConfig as JCandidateConfig
from monosowa_tpu_torch.sowa import candidates
from monosowa_tpu_torch.sowa import candidates_device as T

torch.set_num_threads(1)    # the suite runs six worker processes at once

H = 96
FU = 120.0


def _p2(w):
    return np.array([[FU, 0, w / 2, 0], [0, FU, H / 2, 0], [0, 0, 1, 0]],
                    np.float32)


def _scene(seed=0, w=160,
           car_boxes=((40, 20, 30, 14, 12.0), (100, 40, 40, 22, 7.0)),
           far_box=None):
    """Depth image: 300 m background + ground + car boxes (x1, y1, w, h,
    z) with 1 cm noise, and one mask per box."""
    rng = np.random.default_rng(seed)
    depth = np.full((H, w), 300.0, np.float32)
    vrel = np.maximum(np.arange(H)[:, None] - H / 2, 1)
    depth = np.minimum(depth, (FU * 1.6 / vrel).astype(np.float32)
                       * np.ones((H, w), np.float32))
    masks = []
    for (x1, y1, bw, bh, z) in list(car_boxes) + ([far_box] if far_box
                                                  else []):
        m = np.zeros((H, w), bool)
        m[y1:y1 + bh, x1:x1 + bw] = True
        depth[m] = z + rng.normal(scale=0.01, size=int(m.sum())) \
            .astype(np.float32)
        masks.append(m)
    return depth, masks


def _backproject(depth, w):
    ys, xs = np.mgrid[0:H, 0:w]
    return np.stack([(xs - w / 2) * depth / FU, (ys - H / 2) * depth / FU,
                     depth], -1).reshape(-1, 3).astype(np.float32)


CFG = dict(moving_detection_threshold=2, filter_diameter=4.0)


def _extractors(w, **kw):
    return (J.DeviceExtractor(_p2(w), (H, w), JCandidateConfig(**CFG), **kw),
            T.DeviceExtractor(_p2(w), (H, w), candidates.CandidateConfig(
                **CFG), device="cpu", **kw))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_popcount_and_packing_match_jax():
    rng = np.random.default_rng(0)
    b = np.concatenate([np.arange(256, dtype=np.uint8),
                        rng.integers(0, 256, 4 * 7 * 156 - 256,
                                     dtype=np.uint8)]).reshape(4, 7, 156)
    np.testing.assert_array_equal(T._popcount_sum(_t(b)).numpy(),
                                  np.asarray(J._popcount_sum(jnp.asarray(b))))
    np.testing.assert_array_equal(
        T._popcount_u8(_t(b)).numpy(),
        np.unpackbits(b[..., None], -1).sum(-1))
    bits = rng.random((3, 5, 1248)) < 0.4
    np.testing.assert_array_equal(T._pack_bits(_t(bits)).numpy(),
                                  np.packbits(bits, -1))
    np.testing.assert_array_equal(
        T._unpack_masks(_t(np.packbits(bits, -1)), 1242).numpy(),
        bits[..., :1242])
    np.testing.assert_array_equal(
        T._bits_of(_t(b)).numpy(), np.asarray(J._bits_of(jnp.asarray(b))))


@pytest.mark.parametrize("w", [160, 1242])
def test_erosion_packed_matches_jax(w):
    """One packed erosion and the 40-step chain bit for bit: uint8 shifts
    must drop the high bit as XLA's do; W = 1242 leaves 6 padding bits."""
    rng = np.random.default_rng(w)
    wb = -(-w // 8)
    masks = np.zeros((2, 3, 24, w), bool)
    for f in range(2):
        for m in range(3):
            y0, x0 = rng.integers(0, 12), rng.integers(0, w - 40)
            masks[f, m, y0:y0 + rng.integers(4, 12),
                  x0:x0 + rng.integers(8, 40)] = True
    masks[0, 0, :, :] |= rng.random((24, w)) < 0.6    # ragged, border
    masks[1, 2, :, w - 9:] = True                      # the last columns
    mp = np.packbits(masks, -1)
    first = J._col_bit_mask(w, wb, [0])
    last = J._col_bit_mask(w, wb, [w - 1])
    np.testing.assert_array_equal(
        T._erode_once_packed(_t(mp), _t(first), _t(last)).numpy(),
        np.asarray(J._erode_once_packed(jnp.asarray(mp), jnp.asarray(first),
                                        jnp.asarray(last))))
    struct = rng.integers(1, J.K_MAX + 1, (2, 3)).astype(np.int32)
    got = T._erosion_members_packed(_t(mp), _t(struct), w)
    want = J._erosion_members_packed(jnp.asarray(mp), jnp.asarray(struct), w)
    for g, wt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wt))
    # the bool erosion depth of the unbanked path
    np.testing.assert_array_equal(
        T._erosion_depth(_t(masks)).numpy(),
        np.asarray(J._erosion_depth(jnp.asarray(masks))))


def test_medians_match_jax():
    rng = np.random.default_rng(3)
    f, m, h, w = 2, 3, 8, 24
    vals = rng.normal(10.0, 3.0, (f, h, w, 3)).astype(np.float32)
    vals[0, :, :4] = 7.25                          # ties straddle the split
    members = rng.random((2, f, m, h, w)) < 0.3
    members[0, 1, 2] = False                       # an empty plane
    members[1, 0, 0] = False
    members[1, 0, 0, 3, 5] = True                  # a single member
    planes = np.packbits(members, -1)
    got = T._multi_median_packed(_t(vals), _t(planes)).numpy()
    want = np.asarray(J._multi_median_packed(jnp.asarray(vals),
                                             jnp.asarray(planes)))
    np.testing.assert_array_equal(got, want)
    # the bisection lands within a step of np.median
    k = members[1, 1, 1].reshape(-1)
    np.testing.assert_allclose(got[1, 1, 1],
                               np.median(vals[1].reshape(-1, 3)[k], 0),
                               atol=2e-3)
    flat = vals.reshape(f, 1, h * w, 3).repeat(m, 1)
    mem = members[0].reshape(f, m, h * w)
    np.testing.assert_array_equal(
        T._median3(_t(flat), _t(mem)).numpy(),
        np.asarray(J._median3(jnp.asarray(flat), jnp.asarray(mem))))


def test_compact_bank_matches_jax():
    rng = np.random.default_rng(4)
    f, m, h, w = 2, 3, 10, 40
    full = rng.random((f, m, h, w)) < 0.35
    full[0, 2] = False
    planes = np.packbits(full, -1)
    pts = rng.normal(size=(f, h * w, 3)).astype(np.float32)
    for cap in (16, 150):
        gb, gv = T._compact_bank_packed(_t(pts), _t(planes), cap, w)
        wb_, wv = J._compact_bank_packed(jnp.asarray(pts),
                                         jnp.asarray(planes), cap, w)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(gb.numpy(), np.asarray(wb_))
        # the first cap member pixels in ascending order
        idx = np.nonzero(full[1, 1].reshape(-1))[0][:cap]
        np.testing.assert_array_equal(gb.numpy()[1, 1, :len(idx)],
                                      pts[1, idx])


def _scenes(w):
    return [_scene(0, w), _scene(1, w, car_boxes=((30, 30, 3, 3, 10.0),
                                                  (0, 40, 25, 20, 9.0)),
                                 far_box=(120, 10, 20, 10, 200.0))]


@pytest.mark.parametrize("w", [160, 150])
@pytest.mark.parametrize("depth_u16", [True, False])
def test_extract_frames_banked_matches_jax(w, depth_u16):
    """Two frames and an empty one: one far car (dropped by the 75 m
    gate), a 3 x 3 mask (the erosion fallbacks) and a car on the left
    border (truncated)."""
    scenes = _scenes(w)
    depths = [s[0] for s in scenes] + [scenes[0][0]]
    masks = [s[1] for s in scenes] + [[]]
    ej, et = _extractors(w, depth_u16=depth_u16, frame_bucket=2)
    cj, bj = ej.extract_frames_banked(depths, masks, cap=256)
    ct, bt = et.extract_frames_banked(depths, masks, cap=256)
    assert cj[2] is None and ct[2] is None
    bj = np.asarray(bj)
    assert bt.shape == bj.shape
    n_refs = 0
    for a, b in zip(cj[:2], ct[:2]):
        assert a["points"] == b["points"]          # rows, counts, trunc
        assert len(a["masks"]) == len(b["masks"])
        np.testing.assert_allclose(b["locations"], a["locations"],
                                   atol=2e-3)
        for ref in b["points"]:
            n = ref.count
            np.testing.assert_allclose(bt[ref.row, ref.mi, :n].numpy(),
                                       bj[ref.row, ref.mi, :n], atol=1e-5)
            assert not bt[ref.row, ref.mi, n:].any()
            n_refs += 1
    # the far car is gone, the 3 x 3 mask and the border car stay
    assert n_refs == 4 and len(ct[1]["points"]) == 2
    assert [r.trunc for r in ct[1]["points"]] == [False, True]


@pytest.mark.parametrize("w", [160, 150])
def test_extract_frames_matches_jax(w):
    scenes = _scenes(w)
    depths = [s[0] for s in scenes]
    masks = [s[1] for s in scenes]
    ej, et = _extractors(w)
    for a, b in zip(ej.extract_frames(depths, masks),
                    et.extract_frames(depths, masks)):
        assert len(a["points"]) == len(b["points"]) > 0
        np.testing.assert_allclose(b["locations"], a["locations"],
                                   atol=2e-3)
        for pa, pb in zip(a["points"], b["points"]):
            np.testing.assert_array_equal(pb, pa)


@pytest.mark.parametrize("seed", [0, 1])
def test_device_matches_host_candidates(seed):
    """The port's device extraction against its host extraction on the
    same back-projected cloud (the JAX package's own check)."""
    cfg = candidates.CandidateConfig(**CFG)
    depth, masks = _scene(seed)
    host = candidates.extract_candidates_cam(
        _backproject(depth, 160), _p2(160), (H, 160), masks, cfg)
    dev = T.DeviceExtractor(_p2(160), (H, 160), cfg, device="cpu"
                            ).extract_frames([depth], [masks])[0]
    assert len(dev["points"]) == len(host["points"])
    np.testing.assert_allclose(dev["locations"], host["locations"],
                               atol=5e-3)
    for dp, hp in zip(dev["points"], host["points"]):
        ds = {tuple(np.round(p, 4)) for p in dp}
        hs = {tuple(np.round(p, 4)) for p in hp}
        assert len(ds & hs) / len(ds | hs) > 0.995


def test_banked_and_unbanked_agree():
    """Both device routes read the same float depth: same surviving
    masks, centres within 2e-3 m, the bank's valid points are the first
    ``cap`` member points."""
    depth, masks = _scene(2)
    ext = T.DeviceExtractor(_p2(160), (H, 160),
                            candidates.CandidateConfig(**CFG),
                            depth_u16=False, device="cpu")
    plain = ext.extract_frames([depth], [masks])[0]
    cands, bank = ext.extract_frames_banked([depth], [masks], cap=4096)
    np.testing.assert_allclose(cands[0]["locations"], plain["locations"],
                               atol=2e-3)
    for ref, pts in zip(cands[0]["points"], plain["points"]):
        assert ref.count == len(pts)
        np.testing.assert_allclose(bank[ref.row, ref.mi, :ref.count].numpy(),
                                   pts, atol=1e-5)


def test_empty_and_none_frames():
    depth, masks = _scene(3)
    ext = T.DeviceExtractor(_p2(160), (H, 160), candidates.CandidateConfig(),
                            device="cpu")
    out = ext.extract_frames([None, depth, depth], [[], masks, []])
    assert out[0] is None and out[2] is None
    assert len(out[1]["points"]) > 0
    cands, bank = ext.extract_frames_banked([None, depth], [[], []])
    assert cands == [None, None] and bank is None


def test_cuda_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-fallback check needs none")
    with pytest.raises(RuntimeError, match="cuda"):
        T.DeviceExtractor(_p2(160), (H, 160))
