"""The port's ``ops/geometry.py`` and ``ops/box3d.py`` against the JAX
package's, on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monosowa_tpu.ops import box3d as jbox
from monosowa_tpu.ops import geometry as jgeo
from monosowa_tpu_torch.ops import box3d, geometry

torch.set_num_threads(1)    # the suite runs six worker processes at once


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_rot_y_matches_jax():
    th = np.random.default_rng(0).uniform(-7, 7, (3, 5)).astype(np.float32)
    got = geometry.rot_y(_t(th))
    assert got.shape == (3, 5, 3, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgeo.rot_y(
        jnp.asarray(th))), atol=1e-6)


@pytest.mark.parametrize("n_valid", [0, 1, 6, 7, 32])
def test_masked_median_matches_jax(n_valid):
    """Odd, even and empty masks: the midpoint of the two middle values,
    zero when nothing is valid."""
    rng = np.random.default_rng(n_valid)
    pts = rng.normal(size=(32, 3)).astype(np.float32)
    mask = np.zeros(32, bool)
    mask[rng.permutation(32)[:n_valid]] = True
    want = np.asarray(jgeo.masked_median(jnp.asarray(pts),
                                         jnp.asarray(mask)))
    got = geometry.masked_median(_t(pts), _t(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    if n_valid:
        np.testing.assert_allclose(got.numpy(),
                                   np.median(pts[mask], axis=0), atol=1e-6)
    # batched over cars
    both = geometry.masked_median(_t(np.stack([pts, pts[::-1]])),
                                  _t(np.stack([mask, mask[::-1]])))
    np.testing.assert_array_equal(both[0].numpy(), want)
    np.testing.assert_array_equal(both[1].numpy(), want)


def test_transform_project_corners_obb_match_jax():
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(2, 50, 3)).astype(np.float32) \
        + np.array([0, 0, 10], np.float32)
    tmat = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    tmat[:, :3, :3] = np.asarray(jgeo.rot_y(jnp.asarray(
        np.array([0.3, -1.0], np.float32))))
    tmat[:, :3, 3] = rng.normal(size=(2, 3))
    np.testing.assert_allclose(
        geometry.transform_points(_t(tmat), _t(pts)).numpy(),
        np.asarray(jgeo.transform_points(jnp.asarray(tmat),
                                         jnp.asarray(pts))), atol=1e-5)
    p2 = np.array([[700.0, 0, 600, 40], [0, 700.0, 180, 2], [0, 0, 1, 0.01]],
                  np.float32)
    uv, z = geometry.project_to_image(_t(pts), _t(p2))
    uv_j, z_j = jgeo.project_to_image(jnp.asarray(pts), jnp.asarray(p2))
    np.testing.assert_allclose(uv.numpy(), np.asarray(uv_j), atol=1e-3)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), atol=1e-5)
    center = rng.normal(size=(4, 3)).astype(np.float32)
    lwh = rng.uniform(1, 4, (4, 3)).astype(np.float32)
    ry = rng.uniform(-3, 3, 4).astype(np.float32)
    np.testing.assert_allclose(
        geometry.box3d_corners(_t(center), _t(lwh), _t(ry)).numpy(),
        np.asarray(jgeo.box3d_corners(jnp.asarray(center), jnp.asarray(lwh),
                                      jnp.asarray(ry))), atol=1e-5)
    cloud = rng.normal(scale=1.5, size=(200, 3)).astype(np.float32)
    got = geometry.points_in_obb(_t(cloud), _t(center[0] * 0.1), _t(lwh[0]),
                                 _t(ry[0]))
    want = jgeo.points_in_obb(jnp.asarray(cloud), jnp.asarray(center[0] * .1),
                              jnp.asarray(lwh[0]), jnp.asarray(ry[0]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < 200


def _boxes(seed, n, spread):
    """n car-sized boxes; a small ``spread`` makes them overlap."""
    rng = np.random.default_rng(seed)
    center = np.stack([rng.uniform(-spread, spread, n),
                       rng.uniform(0.8, 1.2, n),
                       10 + rng.uniform(-spread, spread, n)], 1)
    lwh = np.tile(np.array([3.88, 1.63, 1.526]), (n, 1)) \
        * rng.uniform(0.8, 1.2, (n, 1))
    ry = rng.uniform(0, 2 * np.pi, n)
    return (center.astype(np.float32), lwh.astype(np.float32),
            ry.astype(np.float32))


@pytest.mark.parametrize("seed,spread", [(0, 20.0), (1, 3.0), (2, 1.0)])
def test_iou_3d_and_bev_match_jax(seed, spread):
    ca, la, ra = _boxes(seed, 7, spread)
    cb, lb, rb = _boxes(seed + 10, 5, spread)
    got = box3d.iou_3d(_t(ca), _t(la), _t(ra), _t(cb), _t(lb), _t(rb))
    want = np.asarray(jbox.iou_3d(*(jnp.asarray(a)
                                    for a in (ca, la, ra, cb, lb, rb))))
    assert got.shape == (7, 5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    if spread <= 3.0:
        assert want.max() > 0.05
    # a box with itself
    self_iou = box3d.iou_3d(_t(ca), _t(la), _t(ra), _t(ca), _t(la), _t(ra))
    np.testing.assert_allclose(torch.diagonal(self_iou).numpy(), 1.0,
                               atol=1e-4)
    for crit in (-1, 0, 1):
        got = box3d.iou_bev(_t(ca[:, [0, 2]]), _t(la[:, :2]), _t(ra),
                            _t(cb[:, [0, 2]]), _t(lb[:, :2]), _t(rb), crit)
        want = np.asarray(jbox.iou_bev(
            jnp.asarray(ca[:, [0, 2]]), jnp.asarray(la[:, :2]),
            jnp.asarray(ra), jnp.asarray(cb[:, [0, 2]]),
            jnp.asarray(lb[:, :2]), jnp.asarray(rb), crit))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("seed,spread", [(0, 20.0), (1, 4.0), (2, 2.0),
                                         (3, 1.0)])
def test_nms_3d_matches_jax(seed, spread):
    """``keep`` and ``merged`` identical, on far-apart and on overlapping
    boxes, with padded (invalid) boxes and tied scores; batched over
    frames as the labeller calls it."""
    n, frames = 8, 3
    rng = np.random.default_rng(seed)
    per_frame = []
    for f in range(frames):
        c, l, r = _boxes(100 * seed + f, n, spread)
        score = rng.integers(400, 410, n).astype(np.float32)   # ties
        valid = np.ones(n, bool)
        valid[n - f:] = False
        per_frame.append((c, l, r, score, valid))
    stacked = [np.stack([pf[i] for pf in per_frame]) for i in range(5)]
    keep, merged = box3d.nms_3d(*(_t(a) for a in stacked), 0.1)
    assert keep.shape == merged.shape == (frames, n)
    keep_j, merged_j = jax.vmap(jbox.nms_3d, in_axes=(0, 0, 0, 0, 0, None))(
        *(jnp.asarray(a) for a in stacked), jnp.float32(0.1))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(keep_j))
    np.testing.assert_array_equal(merged.numpy(), np.asarray(merged_j))
    if spread <= 2.0:
        assert (~keep.numpy() & stacked[4]).any()     # something merged
    # one frame alone gives the same answer
    k0, m0 = box3d.nms_3d(*(_t(a[0]) for a in stacked), 0.1)
    assert torch.equal(k0, keep[0]) and torch.equal(m0, merged[0])
