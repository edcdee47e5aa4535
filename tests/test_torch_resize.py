"""The port's resizes (``ops/resize.py``) against the JAX package's on the
CPU, and its OpenCV reproductions against ``cv2.resize``.

Tolerances: ``resize_bilinear_torch`` / ``resize_bicubic_torch`` are
``F.interpolate``, the JAX functions dense float32 matrices of the same
rule (built in float64): 1e-5 of the input's magnitude (torch computes
each source coordinate in float32, an ulp of 3.8e-6 at 64 pixels, which
moves the weights by as much; the sums run in another order).
``cv2_resize_linear`` on uint8: equal to cv2 byte for byte; on float32:
4e-6 abs on inputs of magnitude 20 (a float32 ulp at that size is
1.9e-6).  ``cv2_resize_cubic`` on uint8: at most one uint8 step, on at
most 1e-4 of the values (OpenCV 5's float weights are not reproduced bit
for bit; 7.1e-6 of the values differ at the depth backend's 375 x 1242 ->
518 x 1722, 3.1e-5 at 37 x 53 -> 90 x 120; ROADMAP Queue 3)."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from monosowa_tpu.ops import resize as jresize
from monosowa_tpu_torch.ops import resize

cv2 = pytest.importorskip("cv2")

TOL = 1e-5
SIZES = [((13, 21), (29, 50)), ((40, 64), (17, 23)), ((37, 37), (37, 123)),
         ((12, 40), (24, 80)), ((7, 9), (7, 9))]


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("src,dst", SIZES)
def test_bilinear_matches_jax(src, dst, align_corners):
    x = _x((2,) + src + (5,), 0)
    got = resize.resize_bilinear_torch(torch.from_numpy(x), dst,
                                       align_corners).numpy()
    want = np.asarray(jresize.resize_bilinear_torch(jnp.asarray(x), dst,
                                                    align_corners))
    assert got.shape == want.shape == (2,) + dst + (5,)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(x).max())


@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("src,dst", SIZES)
def test_bicubic_matches_jax(src, dst, antialias):
    x = _x((1,) + src + (4,), 1)
    got = resize.resize_bicubic_torch(torch.from_numpy(x), dst,
                                      antialias=antialias).numpy()
    want = np.asarray(jresize.resize_bicubic_torch(jnp.asarray(x), dst,
                                                   antialias=antialias))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(x).max())


def test_bicubic_align_corners_and_3d_input():
    x = _x((9, 14, 3), 2)
    for ac in (False, True):
        got = resize.resize_bicubic_torch(torch.from_numpy(x), (20, 6),
                                          align_corners=ac).numpy()
        want = np.asarray(jresize.resize_bicubic_torch(jnp.asarray(x),
                                                       (20, 6), ac))
        np.testing.assert_allclose(got, want, atol=TOL * np.abs(x).max())
    with pytest.raises(NotImplementedError):
        resize.resize_bicubic_torch(torch.from_numpy(x), (4, 4),
                                    align_corners=True, antialias=True)


# the backends' encodes: the mask backend's 375 x 1242 -> 384 x 1280, the
# depth backend's -> 518 x 1722, and small odd sizes both ways
U8_LINEAR = [((375, 1242), (384, 1280)), ((37, 53), (90, 120)),
             ((500, 1500), (384, 1280)), ((5, 7), (64, 96)),
             ((96, 160), (64, 96))]


@pytest.mark.parametrize("src,dst", U8_LINEAR)
def test_cv2_linear_uint8_is_byte_exact(src, dst):
    img = np.random.default_rng(3).integers(0, 256, src + (3,), np.uint8)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    got = resize.cv2_resize_linear(torch.from_numpy(img), dst).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src,dst", [((375, 1242), (518, 1722)),
                                     ((37, 53), (90, 120)),
                                     ((94, 310), (126, 420)),
                                     ((96, 160), (70, 112))])
def test_cv2_cubic_uint8_within_one_step(src, dst):
    img = np.random.default_rng(4).integers(0, 256, src + (3,), np.uint8)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_CUBIC)
    got = resize.cv2_resize_cubic(torch.from_numpy(img), dst).numpy()
    diff = np.abs(got.astype(int) - want.astype(int))
    print(json.dumps({"cv2_cubic_u8": f"{src}->{dst}",
                      "max_diff": int(diff.max()),
                      "n_diff": int((diff > 0).sum()), "n": diff.size}))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4


@pytest.mark.parametrize("src,dst", [((96, 320), (375, 1242)),
                                     ((16, 24), (94, 310)),
                                     ((30, 40), (20, 25))])
def test_cv2_linear_float(src, dst):
    x = 5 * _x(src + (3,), 5)
    want = cv2.resize(x, dst[::-1], interpolation=cv2.INTER_LINEAR)
    got = resize.cv2_resize_linear(torch.from_numpy(x), dst).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-6)


def test_cv2_resize_rejects_other_layouts():
    with pytest.raises(ValueError):
        resize.cv2_resize_cubic(torch.zeros(4, 4, dtype=torch.uint8), (8, 8))
    with pytest.raises(ValueError):
        resize.cv2_resize_linear(torch.zeros(1, 4, 4, 3), (8, 8))
