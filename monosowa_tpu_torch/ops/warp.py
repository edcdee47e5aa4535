"""OpenCV's image rules on the Waymo stitching path, rebuilt in torch.

The JAX package's ``sowa/waymo2d.py``, ``sowa/stitching.py`` and
``sowa/tracker2d.py`` call four OpenCV functions; the card's machine has no
OpenCV, so each is reproduced here from what OpenCV 5.0 computes, on the
device of its input:

* ``cv2_warp_perspective``: ``cv2.warpPerspective`` with ``INTER_LINEAR``
  and ``BORDER_CONSTANT`` 0.  OpenCV inverts the matrix (the 3 x 3
  cofactor rule in float64), casts the inverse to float32 and maps each
  destination pixel in float32: its vector code, which covers the full
  blocks of 16 columns, forms the row's terms ``y * m1 + m2`` with two
  roundings and then ``fma(x, m0, row)``; the scalar code that finishes a
  row (the columns from ``w // 16 * 16`` on) forms ``fma(x, m0, y * m1)
  + m2``.  Then ``sx = X / W``,
  the floor, the fraction ``a = sx - floor(sx)`` and two fused lerps
  ``p0 = fma(a, p01 - p00, p00)``, ``v = fma(b, p1 - p0, p0)``, taps
  outside the image reading 0, and for uint8 a rounding half to even.  A
  fused multiply-add is computed here in float64 and rounded once.  Equal
  to cv2 on uint8 and float32 images byte for byte in the tests; float64
  images take the same rule in float64 (OpenCV quantises their source
  coordinates to 1/32 pixel: equal where those are whole).  A trailing
  singleton channel is dropped, as cv2 drops it.
* ``cv2_rgb2gray``: ``COLOR_RGB2GRAY`` on uint8, OpenCV's 15-bit fixed
  point ``(9798 R + 19235 G + 3735 B + 2^14) >> 15`` (equal on all 2^24
  colours).
* ``cv2_resize_area``: ``INTER_AREA`` shrinking a uint8 image: integer
  factors average blocks (2 x 2 as ``(s + 2) >> 2``, others as the sum
  times the float32 reciprocal of the area, rounded), other factors take
  OpenCV's area table (weights of the float64 cell edges with its 1e-3
  slack, cast to float32) and sum in float32 in its order: each source
  row across, then the rows down.
* ``match_template_sqdiff``: ``cv2.matchTemplate(..., TM_SQDIFF)`` and
  ``cv2.minMaxLoc``'s minimum location.  The map is ``sum w^2 - 2 corr +
  sum t^2`` with the correlations by FFT in float64 (OpenCV's sums are
  float DFTs rounded to a float32 map; sums reach 8e8, beyond float32's
  whole numbers); the location is the first minimum in raster order.

Every pass is elementwise gathers, multiplies and adds in a fixed order
(the FFT aside): the CPU and the card give the same bits.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch

# the width of OpenCV's vector blocks in warpPerspective's row loop: the
# columns past the last full block take its scalar code
WARP_BLOCK = 16


def cv2_invert_3x3(m) -> np.ndarray:
    """``cv2.invert`` of a 3 x 3 matrix (``DECOMP_LU`` takes the cofactor
    rule for n <= 3), in float64."""
    s = np.asarray(m, np.float64)
    d = (s[0, 0] * (s[1, 1] * s[2, 2] - s[1, 2] * s[2, 1])
         - s[0, 1] * (s[1, 0] * s[2, 2] - s[1, 2] * s[2, 0])
         + s[0, 2] * (s[1, 0] * s[2, 1] - s[1, 1] * s[2, 0]))
    if d == 0:
        return np.zeros((3, 3))
    d = 1.0 / d
    return np.array([
        [(s[1, 1] * s[2, 2] - s[1, 2] * s[2, 1]) * d,
         (s[0, 2] * s[2, 1] - s[0, 1] * s[2, 2]) * d,
         (s[0, 1] * s[1, 2] - s[0, 2] * s[1, 1]) * d],
        [(s[1, 2] * s[2, 0] - s[1, 0] * s[2, 2]) * d,
         (s[0, 0] * s[2, 2] - s[0, 2] * s[2, 0]) * d,
         (s[0, 2] * s[1, 0] - s[0, 0] * s[1, 2]) * d],
        [(s[1, 0] * s[2, 1] - s[1, 1] * s[2, 0]) * d,
         (s[0, 1] * s[2, 0] - s[0, 0] * s[2, 1]) * d,
         (s[0, 0] * s[1, 1] - s[0, 1] * s[1, 0]) * d]])


def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """``fma(a, b, c)`` of float32 operands, rounded once to float32 (the
    float64 product of two float32 values is exact)."""
    return (a.double() * b + c.double()).float()


def _source_coords(m, out_hw, dev, dtype, width=None):
    """(sx, sy) of every destination pixel, (h, w) each, as OpenCV's
    warpPerspective maps them (module docstring) into a destination
    ``width`` wide (default w)."""
    h, w = int(out_hw[0]), int(out_hw[1])
    width = w if width is None else int(width)
    inv = cv2_invert_3x3(m)
    x = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    y = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    if dtype == torch.float64:
        x, y = x.double(), y.double()
        terms = [x * float(inv[r, 0]) + y * float(inv[r, 1])
                 + float(inv[r, 2]) for r in range(3)]
        return terms[0] / terms[2], terms[1] / terms[2]
    mf = inv.astype(np.float32)
    nv = min(width // WARP_BLOCK * WARP_BLOCK, w)   # vector code's columns
    xv, xs = x[:, :nv].expand(h, nv), x[:, nv:].expand(h, w - nv)
    out = []
    for r in range(3):
        m0, m1, m2 = (float(v) for v in mf[r])
        ym = y * m1
        vector_terms = _fma(xv, m0, (ym + m2).expand(h, nv))
        scalar_terms = _fma(xs, m0, ym.expand(h, w - nv)) + m2
        out.append(torch.cat([vector_terms, scalar_terms], 1))
    return out[0] / out[2], out[1] / out[2]


def cv2_warp_perspective(img: torch.Tensor, m, dsize: Sequence[int],
                         crop_hw=None) -> torch.Tensor:
    """``cv2.warpPerspective(img, m, dsize)`` (``INTER_LINEAR``,
    ``BORDER_CONSTANT`` 0) of an (H, W) or (H, W, C) uint8, float32 or
    float64 tensor, on its device; ``dsize`` is (width, height) as cv2
    takes it.  With ``crop_hw`` (rows, cols) only the top-left corner of
    that size is computed, the same values as the full warp's."""
    if img.dtype not in (torch.uint8, torch.float32, torch.float64):
        raise ValueError(f"cv2_warp_perspective: dtype {img.dtype}")
    width = int(dsize[0])
    ow, oh = int(dsize[0]), int(dsize[1])
    if crop_hw is not None:
        oh, ow = min(oh, int(crop_hw[0])), min(ow, int(crop_hw[1]))
    squeeze = img.dim() == 2 or img.shape[-1] == 1
    src = img.reshape(img.shape[0], img.shape[1], -1)
    hs, ws, c = src.shape
    dev = src.device
    work = torch.float64 if img.dtype == torch.float64 else torch.float32
    sx, sy = _source_coords(m, (oh, ow), dev, work, width)
    finite = torch.isfinite(sx) & torch.isfinite(sy)
    fx = torch.floor(torch.where(finite, sx, sx.new_zeros(())))
    fy = torch.floor(torch.where(finite, sy, sy.new_zeros(())))
    a = torch.where(finite, sx - fx, sx.new_zeros(()))[..., None]
    b = torch.where(finite, sy - fy, sy.new_zeros(()))[..., None]
    ix = fx.clamp(-2, ws).long()
    iy = fy.clamp(-2, hs).long()
    flat = src.reshape(-1, c).to(work)

    def tap(dy, dx):
        yy, xx = iy + dy, ix + dx
        ok = finite & (yy >= 0) & (yy < hs) & (xx >= 0) & (xx < ws)
        idx = (yy.clamp(0, hs - 1) * ws + xx.clamp(0, ws - 1)).reshape(-1)
        return flat[idx].reshape(oh, ow, c) * ok[..., None]

    p00, p01, p10, p11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    if work == torch.float64:
        p0 = a * (p01 - p00) + p00
        p1 = a * (p11 - p10) + p10
        v = b * (p1 - p0) + p0
    else:
        p0 = _fma(a, (p01 - p00).double(), p00)
        p1 = _fma(a, (p11 - p10).double(), p10)
        v = _fma(b, (p1 - p0).double(), p0)
    if img.dtype == torch.uint8:
        v = torch.round(v).clamp(0, 255).to(torch.uint8)
    return v[..., 0] if squeeze else v


def cv2_rgb2gray(img: torch.Tensor) -> torch.Tensor:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)`` of an (H, W, 3) uint8
    tensor -> (H, W) uint8, on its device."""
    if img.dim() != 3 or img.shape[-1] != 3 or img.dtype != torch.uint8:
        raise ValueError(f"cv2_rgb2gray: expected (H, W, 3) uint8, got "
                         f"{tuple(img.shape)} {img.dtype}")
    s = img.to(torch.int32)
    y = s[..., 0] * 9798 + s[..., 1] * 19235 + s[..., 2] * 3735
    return ((y + (1 << 14)) >> 15).to(torch.uint8)


@functools.lru_cache(maxsize=32)
def _area_table(src: int, dst: int) -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV's ``computeResizeAreaTab`` for one axis as (dst, k) source
    indices and float32 weights (padded with weight 0, in its order)."""
    scale = 1.0 / (dst / src)
    rows = []
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s1, s2 = math.ceil(f1), math.floor(f2)
        s2 = min(s2, src - 1)
        s1 = min(s1, s2)
        taps = []
        if s1 - f1 > 1e-3:
            taps.append((s1 - 1, (s1 - f1) / cell))
        taps += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            taps.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        rows.append(taps)
    k = max(len(t) for t in rows)
    idx = np.zeros((dst, k), np.int64)
    wts = np.zeros((dst, k), np.float32)
    for d, taps in enumerate(rows):
        for j, (s, wt) in enumerate(taps):
            idx[d, j], wts[d, j] = s, np.float32(wt)
    return idx, wts


def cv2_resize_area(img: torch.Tensor, out_hw) -> torch.Tensor:
    """``cv2.resize(img, (W', H'), interpolation=cv2.INTER_AREA)`` of an
    (H, W) uint8 tensor shrunk (H' <= H, W' <= W), on its device."""
    if img.dim() != 2 or img.dtype != torch.uint8:
        raise ValueError(f"cv2_resize_area: expected (H, W) uint8, got "
                         f"{tuple(img.shape)} {img.dtype}")
    oh, ow = int(out_hw[0]), int(out_hw[1])
    h, w = img.shape
    if oh > h or ow > w:
        raise ValueError("cv2_resize_area: only shrinking is rebuilt "
                         f"({h}x{w} -> {oh}x{ow})")
    sx, sy = 1.0 / (ow / w), 1.0 / (oh / h)
    if sx == int(sx) and sy == int(sy):
        fy, fx = int(sy), int(sx)
        s = img[:oh * fy, :ow * fx].to(torch.int32).reshape(
            oh, fy, ow, fx).sum((1, 3))
        if (fy, fx) == (2, 2):
            return ((s + 2) >> 2).to(torch.uint8)
        v = s.float() * np.float32(1.0 / (fx * fy)).item()
        return torch.round(v).clamp(0, 255).to(torch.uint8)
    dev = img.device
    xi, xw = (torch.from_numpy(a).to(dev) for a in _area_table(w, ow))
    yi, yw = (torch.from_numpy(a).to(dev) for a in _area_table(h, oh))
    s = img.float()
    rows = torch.zeros((h, ow), dtype=torch.float32, device=dev)
    for j in range(xi.shape[1]):
        rows = rows + s[:, xi[:, j]] * xw[None, :, j]
    out = yw[:, 0, None] * rows[yi[:, 0]]
    for j in range(1, yi.shape[1]):
        out = out + yw[:, j, None] * rows[yi[:, j]]
    return torch.round(out).clamp(0, 255).to(torch.uint8)


def _correlate(a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Valid cross-correlation of (H, W) ``a`` with (h, w) ``k`` in
    float64 by FFT -> (H - h + 1, W - w + 1)."""
    hh, ww = a.shape
    kh, kw = k.shape
    fa = torch.fft.rfft2(a, s=(hh, ww))
    fk = torch.fft.rfft2(torch.flip(k, (0, 1)), s=(hh, ww))
    full = torch.fft.irfft2(fa * fk, s=(hh, ww))
    return full[kh - 1:, kw - 1:]


def match_template_sqdiff(window: torch.Tensor, tmpl: torch.Tensor
                          ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """``cv2.matchTemplate(window, tmpl, cv2.TM_SQDIFF)`` of two (H, W)
    float32 tensors as a float64 map, and ``cv2.minMaxLoc``'s minimum
    location (x, y): the first minimum in raster order."""
    w = window.double()
    t = tmpl.double()
    corr = _correlate(w, t)
    box = _correlate(w * w, torch.ones_like(t))
    res = box - 2.0 * corr + (t * t).sum()
    flat = int(torch.argmin(res.reshape(-1)))
    return res, (flat % res.shape[1], flat // res.shape[1])
