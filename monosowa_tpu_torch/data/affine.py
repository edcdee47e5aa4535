"""CenterNet-style 3-point affine transforms.

Behavioral contract: MonoDETR kitti_utils.py:332-391 (get_affine_transform /
affine_transform) — center/scale to output-resolution warp built from three
control points, solved without cv2.
"""

from __future__ import annotations

import numpy as np


def _get_dir(src_point, rot_rad):
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    return np.array([src_point[0] * cs - src_point[1] * sn,
                     src_point[0] * sn + src_point[1] * cs], np.float32)


def _get_3rd_point(a, b):
    direct = a - b
    return b + np.array([-direct[1], direct[0]], np.float32)


def _solve_affine(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Exact affine (2x3) mapping three src points to three dst points."""
    a = np.zeros((6, 6), np.float64)
    b = np.zeros(6, np.float64)
    for i in range(3):
        a[2 * i, 0:2] = src[i]
        a[2 * i, 2] = 1
        a[2 * i + 1, 3:5] = src[i]
        a[2 * i + 1, 5] = 1
        b[2 * i] = dst[i, 0]
        b[2 * i + 1] = dst[i, 1]
    sol = np.linalg.solve(a, b)
    return sol.reshape(2, 3).astype(np.float64)


def get_affine_transform(center, scale, rot, output_size,
                         shift=np.array([0.0, 0.0], np.float32), inv=0):
    if not isinstance(scale, (np.ndarray, list, tuple)):
        scale = np.array([scale, scale], np.float32)
    scale = np.asarray(scale, np.float32)
    center = np.asarray(center, np.float32)
    src_w = scale[0]
    dst_w, dst_h = output_size[0], output_size[1]

    rot_rad = np.pi * rot / 180.0
    src_dir = _get_dir([0, src_w * -0.5], rot_rad)
    dst_dir = np.array([0, dst_w * -0.5], np.float32)

    src = np.zeros((3, 2), np.float32)
    dst = np.zeros((3, 2), np.float32)
    src[0] = center + scale * shift
    src[1] = center + src_dir + scale * shift
    dst[0] = [dst_w * 0.5, dst_h * 0.5]
    dst[1] = np.array([dst_w * 0.5, dst_h * 0.5], np.float32) + dst_dir
    src[2] = _get_3rd_point(src[0], src[1])
    dst[2] = _get_3rd_point(dst[0], dst[1])

    trans = _solve_affine(src, dst)
    if inv:
        return trans, _solve_affine(dst, src)
    return trans


def affine_transform(pt, t):
    p = np.array([pt[0], pt[1], 1.0], np.float64)
    return (t @ p)[:2]


def _fix16(v: float) -> int:
    """16.16 fixed point of v, rounded half up (FLOOR(v * 65536 + 0.5))."""
    return int(np.floor(v * 65536.0 + 0.5))


def _coord(v: np.ndarray) -> np.ndarray:
    """A source coordinate's pixel: truncated, -1 below zero."""
    return np.where(v < 0.0, -1, np.floor(np.clip(v, -1.0, 2.0 ** 31 - 1))
                    ).astype(np.int64)


def _running(start: float, step: float, n: int) -> np.ndarray:
    """start, start + step, (start + step) + step, ... in float64: n values
    summed one step at a time."""
    seq = np.full(n, step, np.float64)
    if n:
        seq[0] = start
    return np.add.accumulate(seq)


def warp_affine_nearest(img: np.ndarray, size, coeffs) -> np.ndarray:
    """PIL's ``Image.transform(size, Image.AFFINE, coeffs,
    resample=Image.NEAREST)`` of a 2-D array, in numpy: output pixel (x, y)
    takes the source pixel under (a x' + b y' + c, d x' + e y' + f) at its
    centre (x' = x + 0.5, y' = y + 0.5), 0 outside the source.

    The pixel arithmetic is PIL's own (libImaging/Geometry.c), so that the
    result equals PIL's pixel for pixel: without rotation or shear (b = d =
    0) the centres are running float64 sums from the first pixel's; else,
    where every corner fits 16.16 fixed point, running sums of the fixed
    point coefficients, shifted down (per row and per column where b and d
    round to 0 there); else running float64 sums in both directions."""
    w, h = (int(v) for v in size)
    a = [float(v) for v in coeffs]
    src_h, src_w = img.shape[:2]
    out = np.zeros((h, w) + img.shape[2:], img.dtype)
    if a[1] == 0 and a[3] == 0:
        xin = _coord(_running(a[2] + a[0] * 0.5, a[0], w))
        yin = _coord(_running(a[5] + a[4] * 0.5, a[4], h))
        xs = (xin >= 0) & (xin < src_w)
        ys = (yin >= 0) & (yin < src_h)
        out[np.ix_(ys, xs)] = img[np.ix_(yin[ys], xin[xs])]
        return out

    def fits(x, y):
        return (abs(x * a[0] + y * a[1] + a[2]) < 32768.0
                and abs(x * a[3] + y * a[4] + a[5]) < 32768.0)

    if all(fits(x, y) for x, y in ((0, 0), (w, h), (0, h), (w, 0))):
        a0, a1, a3, a4 = (_fix16(a[k]) for k in (0, 1, 3, 4))
        a2 = _fix16(a[2] + a[0] * 0.5 + a[1] * 0.5)
        a5 = _fix16(a[5] + a[3] * 0.5 + a[4] * 0.5)
        x = np.arange(w, dtype=np.int64)[None, :]
        y = np.arange(h, dtype=np.int64)[:, None]
        if a1 == 0 and a3 == 0:
            # the dataset's affines: a shear below 2^-17 vanishes in fixed
            # point, so rows and columns map on their own
            xin = ((a2 + x[0] * a0) >> 16)
            yin = ((a5 + y[:, 0] * a4) >> 16)
            xs = (xin >= 0) & (xin < src_w)
            ys = (yin >= 0) & (yin < src_h)
            out[np.ix_(ys, xs)] = img[np.ix_(yin[ys], xin[xs])]
            return out
        xin = (a2 + y * a1 + x * a0) >> 16
        yin = (a5 + y * a4 + x * a3) >> 16
    else:
        xo = _running(a[2] + a[1] * 0.5 + a[0] * 0.5, a[1], h)
        yo = _running(a[5] + a[4] * 0.5 + a[3] * 0.5, a[4], h)
        steps_x = np.full((h, w), a[0], np.float64)
        steps_y = np.full((h, w), a[3], np.float64)
        steps_x[:, 0], steps_y[:, 0] = xo, yo
        xin = _coord(np.add.accumulate(steps_x, axis=1))
        yin = _coord(np.add.accumulate(steps_y, axis=1))
    inside = (xin >= 0) & (xin < src_w) & (yin >= 0) & (yin < src_h)
    out[inside] = img[yin[inside], xin[inside]]
    return out
