"""The labeller's size and robustness stages of the port against the JAX
package's, on the same seeded numpy inputs, on the CPU:
``sowa/dimensions.py`` (1e-5, tests/test_dimensions.py:72),
``sowa/scale.py`` (``optimize_scale``, ``bbox_reduce``,
``extract_scale_lidar_scans``: 1e-5), ``ops/geometry.points_in_obb_r``
(equal), ``sowa/filtering.py`` with ``sowa/hdbscan_np.py`` (the votes and
masks equal); the coverage kernel's cell list at the scale grid's poses
(through its numpy mirror: counts equal to the plain version's); and
the device module's TF32 setting."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from monosowa_tpu.ops import geometry as jgeometry
from monosowa_tpu.ops.geometry import rot_y as jrot_y
from monosowa_tpu.sowa import dimensions as jdims
from monosowa_tpu.sowa import filtering as jfilt
from monosowa_tpu.sowa import hdbscan_np as jhdb
from monosowa_tpu.sowa import scale as jscale
from monosowa_tpu.sowa.templates import TemplateBank as JTemplateBank
from monosowa_tpu_torch import device as device_mod
from monosowa_tpu_torch.ops import geometry, tfl
from monosowa_tpu_torch.sowa import dimensions, filtering, hdbscan_np, scale

torch.set_num_threads(1)    # the suite runs six worker processes at once

T_SCALE, S_SCALE = 200, 512


def _box_cloud(seed, n=None, pad=1600):
    """Surface points of a car-sized box (tests/test_dimensions.py's
    cloud) at a random yaw with noise, padded to ``pad``; and a camera
    frame center."""
    rng = np.random.default_rng(seed)
    n = n or int(rng.integers(300, 1500))
    l, w, h = rng.uniform(3.5, 4.5), rng.uniform(1.5, 1.9), 1.5
    t = rng.uniform(-0.5, 0.5, n)
    side = rng.integers(0, 4, n)
    x = np.where(side == 0, -w / 2, np.where(side == 1, w / 2, t * w))
    z = np.where(side >= 2, np.where(side == 2, -l / 2, l / 2), t * l)
    y = rng.uniform(-h / 2, h / 2, n)
    th = rng.uniform(0, np.pi)
    c, s = np.cos(th), np.sin(th)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    pts = (np.stack([x, y, z], 1) @ rot.T
           + rng.normal(scale=0.03, size=(n, 3))).astype(np.float32)
    out = np.zeros((pad, 3), np.float32)
    mask = np.zeros(pad, bool)
    out[:n], mask[:n] = pts, True
    center = np.array([rng.uniform(-10, 10), 1.0, rng.uniform(5, 30)],
                      np.float32)
    return out, mask, center


@pytest.mark.parametrize("seed", range(4))
def test_dimension_estimator_matches_jax(seed):
    pts, mask, center = _box_cloud(seed)
    th_j, ext_j, sc_j = jdims.estimate_rectangle(jnp.asarray(pts),
                                                 jnp.asarray(mask))
    th_t, ext_t, sc_t = dimensions.estimate_rectangle(
        torch.from_numpy(pts), torch.from_numpy(mask))
    assert float(th_t) == pytest.approx(float(th_j), abs=1e-5)
    np.testing.assert_allclose(ext_t.numpy(), np.asarray(ext_j), atol=1e-5)
    assert float(sc_t) == pytest.approx(float(sc_j), rel=1e-5)
    d_j, e_j = jdims.estimate_dimensions_one(
        jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(center))
    d_t, e_t = dimensions.estimate_dimensions_one(
        torch.from_numpy(pts), torch.from_numpy(mask),
        torch.from_numpy(center))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-5)
    assert float(e_t) == pytest.approx(float(e_j), abs=1e-5)
    frames = np.stack([pts, _box_cloud(seed + 10)[0],
                       _box_cloud(seed + 20)[0]])
    masks = np.stack([mask, _box_cloud(seed + 10)[1],
                      _box_cloud(seed + 20)[1]])
    for force in (True, False):
        got = dimensions.estimate_car_dimensions(
            frames, masks, center, dimensions.DimConfig(
                force_template_dims=force), device="cpu")
        want = jdims.estimate_car_dimensions(
            frames, masks, center,
            jdims.DimConfig(force_template_dims=force))
        np.testing.assert_allclose(got[0], want[0], atol=1e-5)
        assert got[1] == pytest.approx(want[1], abs=1e-5)
        if force:       # the reference's `or True`: the template's dims
            np.testing.assert_allclose(got[0], [3.88, 1.63, 1.526])


def _scale_scene(seed):
    """A template of the bank stretched along its length, posed near a
    fitted pose; the scan padded to S_SCALE."""
    bank = JTemplateBank.default(num_points=T_SCALE)
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 2 * np.pi)
    rot = np.asarray(jrot_y(jnp.float32(theta)))
    cloud = bank.points[seed % 4] * np.array([1.0, 1.0,
                                              rng.uniform(0.9, 1.2)])
    cloud = (cloud @ rot.T + np.array([2.0, 1.0, 15.0])
             + rng.normal(scale=0.02, size=cloud.shape))
    pts = np.zeros((S_SCALE, 3), np.float32)
    pts[:len(cloud)] = cloud
    mask = np.zeros(S_SCALE, bool)
    mask[:len(cloud)] = True
    base = np.array([2.0 + rng.normal(scale=0.2), 1.0,
                     15.0 + rng.normal(scale=0.2), theta + 0.05],
                    np.float32)
    return bank.points, pts, mask, base


@pytest.mark.parametrize("seed", [0, 1])
def test_optimize_scale_matches_jax(seed):
    """Both passes (3,200 poses, then 160) against the JAX package's
    optimize_scale: every field within 1e-5."""
    bank, pts, mask, base = _scale_scene(seed)
    rj = jscale.optimize_scale(jnp.asarray(pts), jnp.asarray(mask),
                               jnp.asarray(bank), jnp.asarray(base))
    rt = scale.optimize_scale(torch.from_numpy(pts), torch.from_numpy(mask),
                              torch.from_numpy(bank), torch.from_numpy(base))
    diff = {k: abs(float(getattr(rt, k)) - float(getattr(rj, k)))
            for k in rj._fields}
    print({"test": "optimize_scale", "seed": seed, **diff})
    assert max(diff.values()) <= 1e-5, diff
    assert float(rt.loss) < -1.0


def test_scale_grid_stays_in_the_cell_list(monkeypatch):
    """The scale grid's poses reach 1.25 x the template's length and
    width and translations of up to |cos + sin| m: the coverage kernel's
    grid rule still gives every pose a cell grid within its cap, and its
    walk (the numpy mirror, ``tfl.cell_walk``) counts what the plain
    version counts, at both passes' poses."""
    bank, pts, mask, base = _scale_scene(2)
    seen = []
    inner = tfl.binary_both_way_loss

    def recording(scan, scan_mask, templates, radius):
        seen.append(templates.clone())
        return inner(scan, scan_mask, templates, radius)

    monkeypatch.setattr(tfl, "binary_both_way_loss", recording)
    scale.optimize_scale(torch.from_numpy(pts), torch.from_numpy(mask),
                         torch.from_numpy(bank), torch.from_numpy(base))
    assert [tuple(p.shape[:1]) for p in seen] == [(3200,), (160,)]
    plan = tfl.tfl_cell_plan(S_SCALE, 0.2)
    for posed in seen:
        sub = posed[::40] if posed.shape[0] > 160 else posed   # 80 poses
        mode, _, _, n = tfl.cell_grid(sub.numpy(), plan)
        assert (mode == 1).all() and (n.prod(-1) <= plan.cell_cap).all()
        walk = tfl.cell_walk(pts[None], mask[None], sub.numpy()[None], 0.2)
        plain = tfl.binary_both_way_counts_plain(
            torch.from_numpy(pts)[None], torch.from_numpy(mask)[None],
            sub[None], 0.2)
        for w, p in zip(walk[:2], plain):
            np.testing.assert_array_equal(w, p.numpy().astype(np.int64))
            assert w.max() > 0
    # the second pass poses around the first pass's best pose
    assert walk[0].max() > 0.5 * T_SCALE


@pytest.mark.parametrize("seed", range(3))
def test_bbox_reduce_and_scale_lidar_match_jax(seed):
    """The box reducer (reduced and fallen-back boxes) and the real-LiDAR
    re-gather through an ego-motion window, within 1e-5 (the gathered
    points the same)."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 2 * np.pi)
    rot = np.asarray(jrot_y(jnp.float32(theta)))
    local = np.stack([rng.uniform(-0.8, 0.8, 800),
                      rng.uniform(-0.7, 0.7, 800),
                      rng.uniform(-1.75, 1.75, 800)], 1)
    center = np.array([1.0, 0.9, 12.0])
    scan = (local @ rot.T + center
            + rng.normal(scale=0.05, size=(800, 3))).astype(np.float32)
    mask = rng.random(800) > 0.1
    for length in (3.5, 3.88, 6.0):       # 6 m: the length falls back
        lwh = np.array([length, 1.63, 1.526], np.float32)
        cj, lj, oj = jscale.bbox_reduce(
            jnp.asarray(scan), jnp.asarray(mask),
            jnp.asarray(center, jnp.float32), jnp.asarray(lwh),
            jnp.float32(theta))
        ct, lt, ot = scale.bbox_reduce(
            torch.from_numpy(scan), torch.from_numpy(mask),
            torch.tensor(center, dtype=torch.float32),
            torch.from_numpy(lwh), torch.tensor(theta, dtype=torch.float32))
        assert bool(ot) == bool(oj) == (length < 6.0)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-5)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5)
    scans = [(scan + rng.normal(scale=0.4, size=scan.shape)
              ).astype(np.float32) for _ in range(3)] + [None]
    tmats = np.stack([np.eye(4)] * 4)
    tmats[:, 2, 3] = [-0.5, 0.0, 0.5, 1.0]
    tmats[0, :3, :3] = np.asarray(jrot_y(jnp.float32(0.05)))
    lwh = np.array([3.88, 1.63, 1.526])
    got = scale.extract_scale_lidar_scans(center, lwh, theta, scans, tmats,
                                          device="cpu")
    want = jscale.extract_scale_lidar_scans(center, lwh, theta, scans,
                                            tmats)
    assert got.shape == want.shape and len(got) > 0
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert scale.extract_scale_lidar_scans(
        center + 100, lwh, theta, scans, tmats, device="cpu").shape == (0, 3)


def test_points_in_obb_r_matches_jax():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-3, 3, (2000, 3)).astype(np.float32)
    from scipy.spatial.transform import Rotation
    rot = Rotation.random(random_state=4).as_matrix().astype(np.float32)
    center = np.array([0.2, -0.1, 0.3], np.float32)
    lwh = np.array([3.9, 1.6, 1.5], np.float32)
    got = geometry.points_in_obb_r(*map(torch.from_numpy,
                                        (pts, center, lwh, rot))).numpy()
    want = np.asarray(jgeometry.points_in_obb_r(*map(jnp.asarray,
                                                     (pts, center, lwh,
                                                      rot))))
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(pts)


def _outlier_cloud(seed):
    """tests/test_filtering.py's cloud: a dense car-scale blob and far
    uniform outliers."""
    rng = np.random.default_rng(seed)
    inliers = rng.normal(scale=[1.8, 0.6, 0.8], size=(1500 + 100 * seed, 3))
    outliers = rng.uniform(-15, 15, size=(60, 3))
    return np.concatenate([inliers, outliers]).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_outlier_votes_and_masks_match_jax(seed):
    """The four fixed-shape votes (a padded tail with ``seed`` 1), the
    ensemble with its second DBSCAN, HDBSCAN noise and the host ensemble
    of the pipeline: equal masks."""
    pts = _outlier_cloud(seed)
    mask = np.ones(len(pts), bool)
    if seed:
        mask[-40:] = False
    p_t, m_t = torch.from_numpy(pts), torch.from_numpy(mask)
    p_j, m_j = jnp.asarray(pts), jnp.asarray(mask)
    for name in ("zscore_outliers", "hbos_outliers", "sor_outliers",
                 "dbscan_noise"):
        got = getattr(filtering, name)(p_t, m_t).numpy()
        want = np.asarray(getattr(jfilt, name)(p_j, m_j))
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert got.any()
    np.testing.assert_array_equal(
        filtering._four_votes(p_t, m_t).numpy(),
        np.asarray(jfilt._four_votes(p_j, m_j)))
    np.testing.assert_array_equal(
        filtering.ensemble_inlier_mask(p_t, m_t).numpy(),
        np.asarray(jfilt.ensemble_inlier_mask(p_j, m_j)))
    dense = pts[mask].astype(np.float64)
    z = (dense - dense.mean(0)) / np.sqrt(dense.var(0) + 1e-9)
    np.testing.assert_array_equal(hdbscan_np.hdbscan_noise(z),
                                  jhdb.hdbscan_noise(z))
    np.testing.assert_array_equal(
        hdbscan_np.hdbscan_labels(z), jhdb.hdbscan_labels(z))
    keep = filtering.ensemble_inlier_mask_host(dense, device="cpu")
    np.testing.assert_array_equal(keep,
                                  jfilt.ensemble_inlier_mask_host(dense))
    n_out = 60 - (len(mask) - int(mask.sum()))     # outliers kept dense
    assert keep[:-n_out].mean() > 0.8 and keep[-n_out:].mean() < 0.5
    assert filtering.ensemble_inlier_mask_host(
        dense[:3], device="cpu").tolist() == [True] * 3


def test_resolve_device_turns_tf32_off(monkeypatch):
    """On a CUDA device ``resolve_device`` sets float32 matrix products
    and convolutions to full float32 (cuBLAS and cuDNN TF32 off), the
    setting every on-card check was taken under; on the CPU the helper
    it calls does the same."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert device_mod.resolve_device("cpu").type == "cpu"
    device_mod.full_float32_matmuls()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            device_mod.resolve_device("cuda")
