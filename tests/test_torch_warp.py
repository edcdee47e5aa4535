"""``ops/warp.py`` against OpenCV (``cv2``) on the CPU: the four OpenCV
functions of the Waymo stitching path, rebuilt in torch.

Bars: ``cv2_warp_perspective`` equal byte for byte on uint8 images (2D,
one and three channels) and float32 masks, on random homographies with
output widths on both sides of OpenCV's 16-column blocks and on the Waymo
layout shrunk as in ``tests/test_waymo2d.py`` and at its production size;
float64 images equal under whole-pixel translations (OpenCV quantises
their coordinates to 1/32 pixel).  ``cv2_rgb2gray`` equal on all 2^24
colours; ``cv2_resize_area`` equal on shrinks by non-integer and integer
factors (Waymo's 1280 x 1920 -> 480 x 640 among them);
``match_template_sqdiff`` at cv2's ``minMaxLoc`` location, its map within
1e-5 of cv2's magnitude (cv2's map is a float32 DFT's: 1.0e-6 apart on
these windows)."""

import numpy as np
import pytest
import torch

from monosowa_tpu_torch.ops import warp
from monosowa_tpu_torch.sowa.waymo2d import PairLayout

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(1)    # the suite runs six worker processes at once

LAYOUT = PairLayout(cam_h=80, cam_w=120, side_h=56, height_pad=10,
                    width_pad=30)


def random_homography(rng):
    return np.eye(3) + np.array([[0.2, 0.1, 30], [0.05, 0.3, 20],
                                 [5e-4, 5e-4, 0]]) * rng.normal(size=(3, 3))


@pytest.mark.parametrize("kind", ["u8_2d", "u8_c1", "u8_c3", "f32_2d",
                                  "f32_c3"])
@pytest.mark.parametrize("out_w", [59, 64, 98, 160, 257])
def test_warp_perspective_random(kind, out_w):
    rng = np.random.default_rng(out_w + len(kind))
    h, w = 90, 130
    shape = {"u8_2d": (h, w), "u8_c1": (h, w, 1), "u8_c3": (h, w, 3),
             "f32_2d": (h, w), "f32_c3": (h, w, 3)}[kind]
    img = (rng.uniform(size=shape).astype(np.float32) if kind[0] == "f"
           else rng.integers(0, 256, shape, dtype=np.uint8))
    for _ in range(3):
        m = random_homography(rng)
        want = cv2.warpPerspective(img, m, (out_w, 77))
        got = warp.cv2_warp_perspective(torch.from_numpy(img), m,
                                        (out_w, 77)).numpy()
        assert got.shape == want.shape     # a singleton channel dropped
        np.testing.assert_array_equal(got, want)


def _layout_homographies():
    cw, y0 = LAYOUT.cam_w, LAYOUT.paste_y0
    right_x0 = LAYOUT.canvas_hw[1] - cw
    shift = np.eye(3)
    shift[0, 2], shift[1, 2] = right_x0 - cw + 8, y0 + 2
    persp = np.array([[0.93, 0.04, right_x0 - cw + 11.5],
                      [-0.02, 1.05, y0 + 1.25], [4e-4, -2e-4, 1.0]])
    return shift, persp


@pytest.mark.parametrize("which", [0, 1])
def test_warp_perspective_waymo_layout(which):
    """A camera into the shrunk pair canvas and a canvas mask back, as
    ``stitch_pair`` and ``unwarp_pair_mask`` warp them."""
    rng = np.random.default_rng(which)
    h = _layout_homographies()[which]
    cam = rng.integers(0, 256, (LAYOUT.cam_h, LAYOUT.cam_w, 3),
                       dtype=np.uint8)
    ch, cw = LAYOUT.canvas_hw
    np.testing.assert_array_equal(
        warp.cv2_warp_perspective(torch.from_numpy(cam), h,
                                  (cw, ch)).numpy(),
        cv2.warpPerspective(cam, h, (cw, ch)))
    mask = (rng.uniform(size=(ch, cw)) > 0.6).astype(np.float32)
    inv = np.linalg.inv(h)
    want = cv2.warpPerspective(mask, inv, (cw, ch))
    got = warp.cv2_warp_perspective(torch.from_numpy(mask), inv,
                                    (cw, ch)).numpy()
    np.testing.assert_array_equal(got, want)


def test_warp_perspective_production_canvas():
    """A 1280 x 1920 camera into the 1380 x 4590 pair canvas."""
    rng = np.random.default_rng(5)
    cam = rng.integers(0, 256, (1280, 1920, 3), dtype=np.uint8)
    h = np.array([[0.9, 0.05, 2300.0], [0.02, 1.05, 40.0],
                  [5e-5, 1e-5, 1.0]])
    np.testing.assert_array_equal(
        warp.cv2_warp_perspective(torch.from_numpy(cam), h,
                                  (4590, 1380)).numpy(),
        cv2.warpPerspective(cam, h, (4590, 1380)))


def test_warp_perspective_float64_translation():
    rng = np.random.default_rng(6)
    img = rng.uniform(0, 255, (LAYOUT.cam_h, LAYOUT.cam_w, 3))
    h = _layout_homographies()[0]
    ch, cw = LAYOUT.canvas_hw
    np.testing.assert_array_equal(
        warp.cv2_warp_perspective(torch.from_numpy(img), h,
                                  (cw, ch)).numpy(),
        cv2.warpPerspective(img, h, (cw, ch)))


def test_rgb2gray_every_colour():
    v = np.arange(256 ** 3, dtype=np.int64)
    img = np.stack([v >> 16, (v >> 8) & 255, v & 255], -1).astype(
        np.uint8).reshape(4096, 4096, 3)
    np.testing.assert_array_equal(
        warp.cv2_rgb2gray(torch.from_numpy(img)).numpy(),
        cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))


@pytest.mark.parametrize("shape", [(100, 130, 64, 64), (128, 192, 48, 64),
                                   (200, 333, 61, 97), (1280, 1920, 480, 640),
                                   (120, 180, 40, 60), (128, 192, 64, 96),
                                   (120, 180, 30, 60)])
def test_resize_area(shape):
    h, w, oh, ow = shape
    img = np.random.default_rng(h + w).integers(0, 256, (h, w),
                                                 dtype=np.uint8)
    np.testing.assert_array_equal(
        warp.cv2_resize_area(torch.from_numpy(img), (oh, ow)).numpy(),
        cv2.resize(img, (ow, oh), interpolation=cv2.INTER_AREA))


def test_resize_area_refuses_enlarging():
    with pytest.raises(ValueError):
        warp.cv2_resize_area(torch.zeros((10, 10), dtype=torch.uint8),
                             (12, 10))


@pytest.mark.parametrize("seed", range(6))
def test_match_template_random(seed):
    rng = np.random.default_rng(seed)
    win = rng.uniform(0, 255, (int(rng.integers(60, 200)),
                               int(rng.integers(60, 200)))).astype(np.float32)
    th, tw = int(rng.integers(5, 50)), int(rng.integers(5, 50))
    y0 = int(rng.integers(0, win.shape[0] - th))
    x0 = int(rng.integers(0, win.shape[1] - tw))
    tmpl = win[y0:y0 + th, x0:x0 + tw] + rng.normal(
        0, 3, (th, tw)).astype(np.float32)
    want = cv2.matchTemplate(win, tmpl, cv2.TM_SQDIFF)
    res, loc = warp.match_template_sqdiff(torch.from_numpy(win),
                                          torch.from_numpy(tmpl))
    assert loc == cv2.minMaxLoc(want)[2] == (x0, y0)
    assert np.abs(res.numpy() - want).max() <= 1e-5 * want.max()


def test_match_template_moving_square():
    """``tests/test_waymo2d.py``'s moving square: the grey of a 0-40
    noise canvas with a 255 square (means of three channels)."""
    rng = np.random.default_rng(3)
    canvas = rng.uniform(0, 40, LAYOUT.canvas_hw + (3,))
    canvas[40:52, 150:166] = 255.0
    gray = canvas.mean(-1).astype(np.float32)
    tmpl = gray[38:54, 146:164].copy()
    canvas[40:52, 150:166] = rng.uniform(0, 40, (12, 16, 3))
    canvas[40:52, 156:172] = 255.0
    gray = canvas.mean(-1).astype(np.float32)
    win = gray[22:70, 128:200]
    want = cv2.matchTemplate(win, tmpl, cv2.TM_SQDIFF)
    _, loc = warp.match_template_sqdiff(torch.from_numpy(win),
                                        torch.from_numpy(tmpl))
    assert loc == cv2.minMaxLoc(want)[2]


@pytest.mark.parametrize("crop", [(40, 120), (77, 64), (13, 97)])
def test_warp_perspective_crop(crop):
    """``crop_hw``: the top-left corner of the full warp, computed alone
    (the column rule of OpenCV's 16-column blocks follows the full
    width)."""
    rng = np.random.default_rng(sum(crop))
    mask = (rng.uniform(size=(90, 270)) > 0.5).astype(np.float32)
    m = random_homography(rng)
    full = cv2.warpPerspective(mask, m, (270, 90))
    got = warp.cv2_warp_perspective(torch.from_numpy(mask), m, (270, 90),
                                    crop_hw=crop).numpy()
    np.testing.assert_array_equal(got, full[:crop[0], :crop[1]])
