"""The port's region growing (``monosowa_tpu_torch/sowa/growing.py``) and
``ops/geometry.voxel_downsample_mask`` against the JAX package's.

RANSAC's triples come from a ``draw`` that repeats ``jax.random.choice``
with the JAX package's keys (``_jax_draw``), so both packages fit the same
hypotheses.  Tolerances: the voxel mask, component labels, grown masks
and grown points equal; the plane within 1e-6 with the same inlier
count."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monosowa_tpu.ops.geometry import voxel_downsample_mask as j_voxel
from monosowa_tpu.sowa import growing as jg
from monosowa_tpu_torch.ops.geometry import voxel_downsample_mask
from monosowa_tpu_torch.sowa import growing

torch.set_num_threads(1)    # the suite runs six worker processes at once


def _jax_draw(keys):
    """A ``draw`` that takes the next key and draws as the JAX
    ``ransac_plane`` does: jax.random.choice(key, n, (H, 3), p=mask/sum)."""
    keys = list(keys)

    def draw(mask, num_hypotheses):
        m = jnp.asarray(mask.cpu().numpy())
        probs = m.astype(jnp.float32) / jnp.maximum(jnp.sum(m), 1)
        tri = jax.random.choice(keys.pop(0), m.shape[0],
                                shape=(num_hypotheses, 3), p=probs)
        return torch.from_numpy(np.asarray(tri).astype(np.int64))
    return draw


def _frame_keys(key):
    """perform_growing_frame's two round keys (jax.random.split)."""
    return list(jax.random.split(jax.random.PRNGKey(0) if key is None
                                 else key))


def test_voxel_downsample_mask_bit_equal_with_points_on_faces():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-3, 3, (3000, 3)).astype(np.float32)
    # multiples of the voxel and their float32 neighbours: on its faces
    # (not those of 0, which are subnormal: XLA flushes them to zero)
    face = np.float32(rng.choice([-3, -2, -1, 1, 2, 3, 13],
                                 (600, 3))) * np.float32(0.2)
    step = rng.integers(-1, 2, (600, 3))
    face = np.where(step > 0, np.nextafter(face, np.float32(np.inf)),
                    np.where(step < 0, np.nextafter(face, np.float32(-np.inf)),
                             face))
    pts[:600] = face
    mask = rng.random(3000) < 0.8
    # there a product with 1/voxel would change the voxel
    assert (np.floor(face / np.float32(0.2))
            != np.floor(face * np.float32(1 / 0.2))).any()
    want = np.asarray(j_voxel(jnp.asarray(pts), jnp.asarray(mask), 0.2))
    got = voxel_downsample_mask(torch.from_numpy(pts),
                                torch.from_numpy(mask), 0.2).numpy()
    np.testing.assert_array_equal(got, want)


def _ground_and_car(seed=0):
    rng = np.random.default_rng(seed)
    ground = np.stack([rng.uniform(-10, 10, 800),
                       np.full(800, 1.65) + rng.normal(scale=0.02, size=800),
                       rng.uniform(0, 30, 800)], 1).astype(np.float32)
    car = np.stack([rng.uniform(-1, 1, 200), rng.uniform(0.2, 1.4, 200),
                    rng.uniform(10, 14, 200)], 1).astype(np.float32)
    return np.concatenate([ground, car])


@pytest.mark.parametrize("seed", [0, 1])
def test_ransac_plane_on_jax_triples(seed):
    pts = _ground_and_car(seed)
    mask = np.ones(len(pts), bool)
    mask[::7] = False
    key = jax.random.PRNGKey(seed)
    abcd_j, n_j = jg.ransac_plane(jnp.asarray(pts), jnp.asarray(mask), key)
    abcd_t, n_t = growing.ransac_plane(torch.from_numpy(pts),
                                       torch.from_numpy(mask),
                                       _jax_draw([key]))
    np.testing.assert_allclose(abcd_t.numpy(), np.asarray(abcd_j),
                               atol=1e-6)
    assert int(n_t) == int(n_j)
    keep_j = jg.remove_plane_points(jnp.asarray(pts), jnp.asarray(mask),
                                    abcd_j)
    keep_t = growing.remove_plane_points(torch.from_numpy(pts),
                                         torch.from_numpy(mask), abcd_t)
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))


def _chain(n, spacing, seed):
    """Points along a line in shuffled index order: min-label propagation
    with pointer jumping does not converge in 24 steps."""
    perm = np.random.default_rng(seed).permutation(n)
    pts = np.zeros((n, 3), np.float32)
    pts[perm, 0] = np.arange(n) * spacing
    pts[:, 1] = np.float32(0.01) * (perm % 3)
    return pts


def _components_scene(scene):
    rng = np.random.default_rng(1)
    if scene == "clusters":
        pts = np.concatenate([rng.normal(scale=0.4, size=(300, 3)),
                              rng.uniform(0, 5, (400, 3))]).astype(
                                  np.float32)
    else:
        pts = _chain(1500, 0.05, 2)
    mask = rng.random(len(pts)) < (0.9 if scene == "clusters" else 1.0)
    return pts, mask


@pytest.mark.parametrize("scene,threshold", [
    ("clusters", 0.3), ("clusters", 0.5), ("chain", 0.07)])
def test_connected_components_labels_equal(scene, threshold):
    pts, mask = _components_scene(scene)
    want = np.asarray(jg.connected_components(
        jnp.asarray(pts), jnp.asarray(mask), threshold))
    got = growing.connected_components(torch.from_numpy(pts),
                                       torch.from_numpy(mask),
                                       threshold).numpy()
    np.testing.assert_array_equal(got, want)
    if scene == "chain":     # the 24 steps left it unconverged
        assert len(np.unique(want)) > 1


@pytest.mark.parametrize("scene,threshold", [
    ("clusters", 0.5), ("chain", 0.07)])
def test_labels_equal_in_small_blocks_and_edge_chunks(scene, threshold,
                                                      monkeypatch):
    """The paths a large crop takes on the card, at a size the JAX dense
    form can take: blocks halved below the first row's window (a block's
    budget of 2^12 elements) and the edges scattered in chunks of 2^8."""
    monkeypatch.setattr(growing, "_BLOCK_ELEMS", 1 << 12)
    monkeypatch.setattr(growing, "_EDGE_CHUNK", 1 << 8)
    pts, mask = _components_scene(scene)
    ei, _, _ = growing.neighbor_edges(torch.from_numpy(pts),
                                      torch.from_numpy(mask), threshold)
    assert ei.numel() > 4 * growing._EDGE_CHUNK
    want = np.asarray(jg.connected_components(
        jnp.asarray(pts), jnp.asarray(mask), threshold))
    got = growing.connected_components(torch.from_numpy(pts),
                                       torch.from_numpy(mask),
                                       threshold).numpy()
    np.testing.assert_array_equal(got, want)


def test_neighbor_edges_are_the_dense_adjacency():
    rng = np.random.default_rng(3)
    pts = rng.uniform(0, 3, (500, 3)).astype(np.float32)
    mask = rng.random(500) < 0.9
    t = 0.4
    ei, ej, d2 = growing.neighbor_edges(torch.from_numpy(pts),
                                        torch.from_numpy(mask), t)
    dense = np.zeros((3, 500, 500), np.float32)
    for k in range(3):
        diff = pts[:, None, k] - pts[None, :, k]
        dense[k] = diff * diff
    d2_dense = (dense[0] + dense[1]) + dense[2]
    t2 = np.float32(np.float32(t) * np.float32(t))
    adj = (d2_dense <= t2) & mask[:, None] & mask[None, :]
    adj &= np.triu(np.ones((500, 500), bool), 1)
    want = set(zip(*np.nonzero(adj)))
    got = {(min(i, j), max(i, j)) for i, j in zip(ei.tolist(), ej.tolist())}
    assert got == want and len(got) == ei.numel()
    np.testing.assert_array_equal(
        d2.numpy(), d2_dense[ei.long().numpy(), ej.long().numpy()])


def _two_blobs(seed, offset, n_car=150, n_bg=150):
    rng = np.random.default_rng(seed)
    car = rng.normal(scale=0.3, size=(n_car, 3)).astype(np.float32)
    bg = (rng.normal(scale=0.3, size=(n_bg, 3))
          + np.array([offset, 0, 0])).astype(np.float32)
    pts = np.concatenate([car, bg])
    car_mask = np.zeros(len(pts), bool)
    car_mask[:n_car] = True
    return pts, car_mask


@pytest.mark.parametrize("seed,offset,threshold,n_bg", [
    (2, 8.0, 0.5, 150),     # the car's component kept, the wall dropped
    (3, 0.8, 0.6, 500),     # a leaky region (overlap < 0.95) dropped
])
def test_grow_mask_and_largest_region_equal(seed, offset, threshold, n_bg):
    pts, car_mask = _two_blobs(seed, offset, n_car=150 if n_bg == 150
                               else 50, n_bg=n_bg)
    mask = np.ones(len(pts), bool)
    want = np.asarray(jg.grow_mask(jnp.asarray(pts), jnp.asarray(mask),
                                   jnp.asarray(car_mask),
                                   jnp.float32(threshold)))
    got = growing.grow_mask(torch.from_numpy(pts), torch.from_numpy(mask),
                            torch.from_numpy(car_mask), threshold).numpy()
    np.testing.assert_array_equal(got, want)
    thresholds = (0.1, 0.3, threshold)
    want_r = jg.largest_region(pts, mask, car_mask, thresholds)
    got_r = growing.largest_region(pts, mask, car_mask, thresholds,
                                   device="cpu")
    assert (want_r is None) == (got_r is None)
    if want_r is not None:
        np.testing.assert_array_equal(got_r.numpy(), want_r)


def _growing_scene(seed=4):
    rng = np.random.default_rng(seed)
    ground = np.stack([rng.uniform(-10, 10, 600),
                       np.full(600, 1.65) + rng.normal(scale=0.01, size=600),
                       rng.uniform(0, 30, 600)], 1).astype(np.float32)
    car = np.stack([rng.uniform(-0.8, 0.8, 200), rng.uniform(0.3, 1.4, 200),
                    rng.uniform(10, 13.5, 200)], 1).astype(np.float32)
    pts = np.concatenate([ground, car])
    car_mask = np.zeros(len(pts), bool)
    car_mask[600:790] = True
    return pts, car_mask


def test_perform_growing_equal():
    pts, car_mask = _growing_scene()
    mask = np.ones(len(pts), bool)
    key = jax.random.PRNGKey(1)
    want = np.asarray(jg.perform_growing(
        jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(car_mask), key))
    got = growing.perform_growing(torch.from_numpy(pts),
                                  torch.from_numpy(mask),
                                  torch.from_numpy(car_mask),
                                  _jax_draw([key])).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[600:790].mean() > 0.9 and got[:600].mean() < 0.1


def _frame_scan(pts, h=40, w=60, seed=5):
    """pts (N, 3) as the (N, 6) [x, y, z, camera_idx, px, py] layout: a
    pixel per point, camera 0 (and a share on camera 1)."""
    rng = np.random.default_rng(seed)
    n = len(pts)
    px = rng.integers(0, h, n)
    py = rng.integers(0, w, n)
    cam = (rng.random(n) < 0.1).astype(np.float32)
    return np.concatenate([pts, cam[:, None], px[:, None].astype(np.float32),
                           py[:, None].astype(np.float32)], 1)


def _frame_case(case):
    """(scan, mask_img) for perform_growing_frame and each of its
    early-outs."""
    pts, car_mask = _growing_scene()
    scan = _frame_scan(pts)
    h, w = 40, 60
    mask_img = np.zeros((h, w), bool)
    car_pix = scan[600:790]
    mask_img[car_pix[:, 4].astype(int), car_pix[:, 5].astype(int)] = True
    if case == "full":
        return scan, mask_img
    if case == "empty frustum":
        return scan, np.zeros((h, w), bool)
    if case == "few crop points":      # the crop far from every point
        scan = scan.copy()
        scan[:, 0] += np.where(np.arange(len(scan)) < 2, 0.0, 100.0)
        m = np.zeros((h, w), bool)
        m[scan[:2, 4].astype(int), scan[:2, 5].astype(int)] = True
        return scan, m
    if case == "degenerate plane":     # one voxel: fewer than 3 after it
        scan = scan.copy()
        scan[:, :3] = np.float32(0.05)
        return scan, mask_img
    if case == "no accepted region":   # the frustum on ground points only
        m = np.zeros((h, w), bool)
        g = scan[:600]
        m[g[:5, 4].astype(int), g[:5, 5].astype(int)] = True
        return scan, m
    raise KeyError(case)


@pytest.mark.parametrize("case", ["full", "empty frustum", "few crop points",
                                  "degenerate plane", "no accepted region"])
def test_perform_growing_frame_equal(case):
    scan, mask_img = _frame_case(case)
    key = jax.random.PRNGKey(3)
    want = jg.perform_growing_frame(scan, mask_img, 0, key)
    got = growing.perform_growing_frame(scan, mask_img, 0,
                                        _jax_draw(_frame_keys(key)),
                                        device="cpu")
    assert (want is None) == (got is None), (want, got)
    if case == "full":
        assert want is not None and len(want) > 100
    else:
        assert want is None
    if want is not None:
        np.testing.assert_array_equal(got, want)


def test_default_draw_is_seeded_and_device_pinned():
    mask = torch.from_numpy(np.random.default_rng(0).random(100) < 0.5)
    a = growing.make_draw(3, "cpu")(mask, 16)
    b = growing.make_draw(3, "cpu")(mask, 16)
    assert torch.equal(a, b) and bool(mask[a].all())
