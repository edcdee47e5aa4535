"""Image resizing with the rules of ``torch.nn.functional.interpolate`` and
of OpenCV's ``cv2.resize``, on NHWC tensors.

Counterpart of the JAX package's ``ops/resize.py``: the model zoo's
networks (the DINOv2 position grid, the DPT fusion neck, the Mask2Former
attention masks) were trained with ``F.interpolate``, so the JAX package
rebuilt its rules as dense (D, S) matrices.  Here the rules are torch's
own, so ``resize_bilinear_torch`` and ``resize_bicubic_torch`` call
``F.interpolate`` on an NHWC view (no copy: the view is channels-last):

* ``align_corners=True``: source coordinate ``i * (S-1)/(D-1)``;
* ``align_corners=False``: half-pixel centres, replicate border, no
  anti-aliasing on a downsize;
* bicubic with A = -0.75, or with ``antialias=True`` torch's antialiased
  kernel (A = -0.5, scaled to the downsize factor, normalised).

The zoo's backends encode their images as the JAX package does, with
OpenCV on uint8 frames; the card's machine has no OpenCV, so
``cv2_resize_linear`` and ``cv2_resize_cubic`` reproduce ``cv2.resize``
(OpenCV 5.0) in torch:

* ``INTER_LINEAR`` on uint8: 11-bit fixed-point weights of the float32
  half-pixel coordinate (clamped to the image in x, rows replicated in y),
  a horizontal pass in int32, and the vertical pass as OpenCV's vector
  code computes it, ``((r0 >> 4) * b0 >> 16) + ((r1 >> 4) * b1 >> 16)``,
  rounded by ``(v + 2) >> 2``: equal to cv2 byte for byte;
* ``INTER_LINEAR`` on float32: the same taps with float weights of the
  float64 coordinate, horizontal then vertical;
* ``INTER_CUBIC`` on uint8: OpenCV 5 resizes 8-bit images with float
  weights and rounds half to even at the end; its exact float weights are
  not reproduced here (these are float64 products of the float32
  coordinate, cast once), so about 1 value in 100,000 lands one uint8 step
  away from cv2 (19 of 2,675,988 at 375 x 1242 -> 518 x 1722 on the
  tests' image; ROADMAP Queue 3).

Every pass is elementwise (gathers, multiplies and adds in a fixed order):
the CPU and the card give the same bits.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _interpolate_nhwc(x: torch.Tensor, out_hw: Sequence[int],
                      **kw) -> torch.Tensor:
    """(..., H, W, C) -> (..., H', W', C) through ``F.interpolate`` in
    float32 (float64 for float64 x), returned in x's dtype."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    lead = x.shape[:-3]
    h, w, c = x.shape[-3:]
    y = x.reshape(-1, h, w, c).to(torch.promote_types(
        x.dtype, torch.float32)).permute(0, 3, 1, 2)
    y = F.interpolate(y, size=(oh, ow), **kw)
    return y.permute(0, 2, 3, 1).reshape(*lead, oh, ow, c).to(x.dtype)


def resize_bilinear_torch(x: torch.Tensor, out_hw,
                          align_corners: bool = False,
                          antialias: bool = False) -> torch.Tensor:
    """``F.interpolate(mode='bilinear')`` of (..., H, W, C); with
    ``antialias`` an axis that shrinks takes the triangle filter widened to
    the shrink factor (``jax.image.resize``'s "linear"), one that grows the
    plain half-pixel rule."""
    if antialias and align_corners:
        raise NotImplementedError("torch AA path is align_corners=False")
    return _interpolate_nhwc(x, out_hw, mode="bilinear",
                             align_corners=align_corners,
                             antialias=antialias)


def resize_bicubic_torch(x: torch.Tensor, out_hw, align_corners: bool = False,
                         antialias: bool = False) -> torch.Tensor:
    """``F.interpolate(mode='bicubic')`` of (..., H, W, C)."""
    if antialias and align_corners:
        raise NotImplementedError("torch AA path is align_corners=False")
    return _interpolate_nhwc(x, out_hw, mode="bicubic",
                             align_corners=align_corners,
                             antialias=antialias)


# ---------------------------------------------------------------------------
# cv2.resize
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _cv2_taps(dst: int, src: int, cubic: bool, coord64: bool, clamp: bool
              ) -> Tuple[np.ndarray, np.ndarray]:
    """(dst, k) source indices (replicated at the border) and (dst, k)
    float32 weights of one axis, as ``cv2.resize`` makes them: the
    half-pixel coordinate in float32 or (``coord64``) float64; linear
    weights (1 - f, f), with the coordinate clamped to the image where
    OpenCV clamps it (columns, ``clamp``), or the cubic weights of A =
    -0.75 (k = 4)."""
    scale = src / dst
    idx, wts = [], []
    for d in range(dst):
        if coord64:
            x = (d + 0.5) * scale - 0.5
            i = int(np.floor(x))
            f = np.float32(x - i)
        else:
            x = np.float32((d + 0.5) * scale - 0.5)
            i = int(np.floor(x))
            f = np.float32(x - np.float32(i))
        if cubic:
            t, a = float(f), -0.75
            w = [((a * (t + 1) - 5 * a) * (t + 1) + 8 * a) * (t + 1) - 4 * a,
                 ((a + 2) * t - (a + 3)) * t * t + 1,
                 ((a + 2) * (1 - t) - (a + 3)) * (1 - t) * (1 - t) + 1]
            w.append(1.0 - w[0] - w[1] - w[2])
            taps = [i - 1, i, i + 1, i + 2]
        else:
            if clamp and i < 0:
                i, f = 0, np.float32(0)
            if clamp and i >= src - 1:
                i, f = src - 1, np.float32(0)
            w = [np.float32(1) - f, f]
            taps = [i, i + 1]
        idx.append(np.clip(taps, 0, src - 1))
        wts.append(w)
    return np.array(idx, np.int64), np.array(wts, np.float32)


@functools.lru_cache(maxsize=64)
def _taps(dev, *key):
    """``_cv2_taps`` on ``dev``, copied once."""
    idx, wts = _cv2_taps(*key)
    return torch.from_numpy(idx).to(dev), torch.from_numpy(wts).to(dev)


def _check_hwc(img: torch.Tensor, dtype) -> None:
    if img.dim() != 3 or img.dtype != dtype:
        raise ValueError(f"expected an (H, W, C) {dtype} image, got "
                         f"{tuple(img.shape)} {img.dtype}")


def cv2_resize_linear(img: torch.Tensor, out_hw) -> torch.Tensor:
    """``cv2.resize(img, (W', H'), interpolation=cv2.INTER_LINEAR)`` of an
    (H, W, C) uint8 or float32 image, on its device."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    h, w = img.shape[:2]
    dev = img.device
    if img.dtype == torch.uint8:
        _check_hwc(img, torch.uint8)
        ix, ax = _taps(dev, ow, w, False, False, True)
        iy, ay = _taps(dev, oh, h, False, False, False)
        ax = torch.round(ax * 2048).to(torch.int32)
        ay = torch.round(ay * 2048).to(torch.int32)
        s = img.to(torch.int32)
        rows = s[:, ix[:, 0]] * ax[None, :, 0, None] \
            + s[:, ix[:, 1]] * ax[None, :, 1, None]
        r0, r1 = rows[iy[:, 0]], rows[iy[:, 1]]
        v = (((r0 >> 4) * ay[:, 0, None, None]) >> 16) \
            + (((r1 >> 4) * ay[:, 1, None, None]) >> 16)
        return ((v + 2) >> 2).clamp(0, 255).to(torch.uint8)
    _check_hwc(img, torch.float32)
    ix, ax = _taps(dev, ow, w, False, True, True)
    iy, ay = _taps(dev, oh, h, False, True, False)
    rows = img[:, ix[:, 0]] * ax[None, :, 0, None] \
        + img[:, ix[:, 1]] * ax[None, :, 1, None]
    return rows[iy[:, 0]] * ay[:, 0, None, None] \
        + rows[iy[:, 1]] * ay[:, 1, None, None]


def cv2_resize_cubic(img: torch.Tensor, out_hw) -> torch.Tensor:
    """``cv2.resize(img, (W', H'), interpolation=cv2.INTER_CUBIC)`` of an
    (H, W, C) uint8 image, on its device: float32 passes, rounded half to
    even and saturated to uint8 (within one uint8 step of OpenCV 5)."""
    _check_hwc(img, torch.uint8)
    oh, ow = int(out_hw[0]), int(out_hw[1])
    h, w = img.shape[:2]
    ix, ax = _taps(img.device, ow, w, True, True, False)
    iy, ay = _taps(img.device, oh, h, True, True, False)
    s = img.float()
    rows = s[:, ix[:, 0]] * ax[None, :, 0, None]
    for k in range(1, 4):
        rows = rows + s[:, ix[:, k]] * ax[None, :, k, None]
    out = rows[iy[:, 0]] * ay[:, 0, None, None]
    for k in range(1, 4):
        out = out + rows[iy[:, k]] * ay[:, k, None, None]
    return torch.round(out).clamp(0, 255).to(torch.uint8)
