"""The pseudo-labeller's fit path as a whole: ``PseudoLabeler.label_frame``,
``label_and_write`` and ``label_frames`` of the port against the JAX
package's, on the synthetic scene of ``tests/test_pipeline_e2e.py`` (one
rendered car across a short ego-motion window) and a two-car variant in
which the 3D NMS merges and re-fits.  Both labellers fit with the same
arrays (``convert.load_labeler_state``) at a small grid.

Tolerances: the same number of cars, ``moving`` flags and 2D boxes
identical, x / y / z within 1e-4 m, theta within 1e-4 rad, and the label
files equal line for line (the writer rounds to two decimals)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch

from monosowa_tpu.ops.geometry import rot_y
from monosowa_tpu.sowa import aggregation as jagg
from monosowa_tpu.sowa import candidates as jcand
from monosowa_tpu.sowa import lomm as jlomm
from monosowa_tpu.sowa import pipeline as jpipe
from monosowa_tpu.sowa.fitting import FitConfig as JFitConfig
from monosowa_tpu.sowa.templates import TemplateBank as JTemplateBank
from monosowa_tpu_torch import convert
from monosowa_tpu_torch.kittiio import read_label_file
from monosowa_tpu_torch.sowa import aggregation, candidates, lomm, pipeline
from monosowa_tpu_torch.sowa.fitting import FitConfig
from monosowa_tpu_torch.sowa.templates import TemplateBank

torch.set_num_threads(1)    # the suite runs six worker processes at once

H, W = 180, 400
P2 = np.array([[250.0, 0, W / 2, 0], [0, 250.0, H / 2, 0], [0, 0, 1, 0]])
TRUE_POSE = dict(x=1.0, y=0.9, z=14.0, theta=0.6)
SECOND_POSE = dict(x=1.9, y=0.9, z=14.9, theta=0.75)
GRID = dict(n_dx=11, n_dz=11, n_theta=8, n_theta_fine=36, fine_chunk=12)
N_TEMPLATE = 300
WINDOW = list(range(-3, 4))


def _make_scene(poses=(TRUE_POSE,), n_frames=7, seed=0):
    """Returns (points_per_frame, masks_per_frame, transforms): the scene
    of tests/test_pipeline_e2e.py with one mask per car."""
    rng = np.random.default_rng(seed)
    car_local = JTemplateBank.default(num_points=N_TEMPLATE).points[0]
    cars_ref = []
    for pose in poses:
        rot = np.asarray(rot_y(jnp.float32(pose["theta"])))
        cars_ref.append(car_local @ rot.T + np.array(
            [pose["x"], pose["y"], pose["z"]]))

    pts_frames, mask_frames, transforms = [], [], []
    ref = n_frames // 2
    for k in range(n_frames):
        # ego moves forward 0.5 m/frame along +z
        t_cur_to_ref = np.eye(4)
        t_cur_to_ref[2, 3] = (k - ref) * -0.5
        transforms.append(t_cur_to_ref)
        t_ref_to_cur = np.linalg.inv(t_cur_to_ref)
        clouds, masks = [], []
        for car_ref in cars_ref:
            car_cur = car_ref @ t_ref_to_cur[:3, :3].T + t_ref_to_cur[:3, 3]
            car_cur = car_cur + rng.normal(scale=0.02, size=car_cur.shape)
            clouds.append(car_cur)
            # mask from the car's projection, dilated
            hom = np.hstack([car_cur, np.ones((len(car_cur), 1))]) @ P2.T
            uv = np.rint(hom[:, :2] / hom[:, 2:3]).astype(int)
            ok = ((uv[:, 0] >= 0) & (uv[:, 0] < W)
                  & (uv[:, 1] >= 0) & (uv[:, 1] < H))
            mask = np.zeros((H, W), bool)
            mask[uv[ok, 1], uv[ok, 0]] = True
            masks.append(scipy.ndimage.binary_dilation(mask, iterations=3))
        ground = np.stack([rng.uniform(-8, 8, 600),
                           np.full(600, 1.66),
                           rng.uniform(4, 30, 600)], 1)
        pts_frames.append(np.concatenate(clouds + [ground])
                          .astype(np.float32))
        mask_frames.append(masks)
    return pts_frames, mask_frames, np.stack(transforms)


def _configs(**kw):
    common = dict(nscans_before=3, nscans_after=3, max_cars=4,
                  max_points=512, min_standing_points=400, fit_bucket=2, **kw)
    return (jpipe.PipelineConfig(fit=JFitConfig(**GRID), **common),
            pipeline.PipelineConfig(fit=FitConfig(**GRID), **common))


@pytest.fixture(scope="module")
def labelers():
    """The two labellers with the same template bank and conv kernels."""
    cfg_j, cfg_t = _configs()
    lab_j = jpipe.PseudoLabeler(
        cfg_j, bank=JTemplateBank.default(num_points=N_TEMPLATE))
    lab_t = pipeline.PseudoLabeler(
        cfg_t, bank=TemplateBank.default(num_points=N_TEMPLATE),
        device="cpu")
    # the port's own state equals the JAX package's, bit for bit
    np.testing.assert_array_equal(lab_t.bank.points, lab_j.bank.points)
    np.testing.assert_array_equal(lab_t.occ_kernels.numpy(),
                                  np.asarray(lab_j.occ_kernels))
    np.testing.assert_array_equal(lab_t.memb_kernels.numpy(),
                                  np.asarray(lab_j.memb_kernels))
    convert.load_labeler_state(lab_t, lab_j.bank.points,
                               np.asarray(lab_j.occ_kernels),
                               np.asarray(lab_j.memb_kernels))
    return lab_j, lab_t


def _frame_args(scene):
    pts, masks, transforms = scene
    return dict(get_points=lambda k: pts[k], get_masks=lambda k: masks[k],
                transforms=transforms, p2=P2, img_hw=(H, W))


def _assert_cars_match(cars_t, cars_j, dims_atol: float = 0.0):
    """Equal cars; the dimensions equal (the template's) or, where a size
    stage measured them, within ``dims_atol``."""
    assert len(cars_t) == len(cars_j)
    worst = {"xyz": 0.0, "theta": 0.0}
    for ct, cj in zip(cars_t, cars_j):
        assert ct["cls"] == cj["cls"] == "Car"
        assert ct["moving"] == cj["moving"]
        assert ct["num_points"] == cj["num_points"]
        np.testing.assert_array_equal(ct["box2d"], cj["box2d"])
        np.testing.assert_array_equal(ct["points"], cj["points"])
        for k in ("h", "w", "l"):
            assert abs(ct[k] - cj[k]) <= dims_atol, (k, ct[k], cj[k])
        for k in ("x", "y", "z"):
            worst["xyz"] = max(worst["xyz"], abs(ct[k] - cj[k]))
        dth = abs((ct["theta"] - cj["theta"] + np.pi) % (2 * np.pi) - np.pi)
        worst["theta"] = max(worst["theta"], dth)
    print({"test": "labeller cars", "n": len(cars_t), **worst})
    assert worst["xyz"] <= 1e-4 and worst["theta"] <= 1e-4, worst


def test_label_frame_matches_jax(labelers):
    lab_j, lab_t = labelers
    scene = _make_scene()
    cars_j = lab_j.label_frame(WINDOW, 3, **_frame_args(scene))
    cars_t = lab_t.label_frame(WINDOW, 3, **_frame_args(scene))
    assert len(cars_t) == 1 and not cars_t[0]["moving"]
    _assert_cars_match(cars_t, cars_j)
    # the coarse test grid still finds the car (0.4 m voxels)
    assert abs(cars_t[0]["x"] - TRUE_POSE["x"]) < 0.6
    assert abs(cars_t[0]["z"] - TRUE_POSE["z"]) < 0.6
    assert abs(cars_t[0]["y"] - TRUE_POSE["y"]) < 0.3


def test_two_cars_nms_merges_and_refits_like_jax(labelers):
    """Two overlapping cars: the 3D NMS suppresses one, its points merge
    into the winner, and the winner is fitted again."""
    lab_j, lab_t = labelers
    scene = _make_scene((TRUE_POSE, SECOND_POSE), seed=1)
    cars_j = lab_j.label_frame(WINDOW, 3, **_frame_args(scene))
    cars_t = lab_t.label_frame(WINDOW, 3, **_frame_args(scene))
    assert len(cars_t) == 1          # two tracks in, one car out
    _assert_cars_match(cars_t, cars_j)


def test_label_and_write_matches_jax(labelers, tmp_path):
    lab_j, lab_t = labelers
    scene = _make_scene()
    out_j, out_t = tmp_path / "jax" / "000003.txt", tmp_path / "t" / "3.txt"
    cars_j = lab_j.label_and_write(str(out_j), WINDOW, 3,
                                   **_frame_args(scene))
    cars_t = lab_t.label_and_write(str(out_t), WINDOW, 3,
                                   **_frame_args(scene))
    _assert_cars_match(cars_t, cars_j)
    assert out_t.read_text() == out_j.read_text() != ""
    labels = read_label_file(str(out_t))
    assert labels.names == ["Car"]
    # skip-if-exists: a second call returns None and leaves the file
    assert lab_t.label_and_write(str(out_t), WINDOW, 3,
                                 **_frame_args(scene)) is None


def test_empty_frame_writes_empty_file(labelers, tmp_path):
    _, lab_t = labelers
    out = tmp_path / "empty.txt"
    cars = lab_t.label_and_write(
        str(out), WINDOW, 3, get_points=lambda k: None,
        get_masks=lambda k: None,
        transforms=np.tile(np.eye(4), (7, 1, 1)), p2=P2, img_hw=(H, W))
    assert cars == []
    assert out.read_text() == ""


def _jobs(out_dir, with_ids):
    """Three reference frames over one 9-frame two-car sequence, windows of
    +-3 frames that overlap; the first frame's second car makes the NMS
    merge in every window."""
    pts, masks, transforms = _make_scene((TRUE_POSE, SECOND_POSE),
                                         n_frames=9, seed=2)
    jobs = []
    for ref in (3, 4, 5):
        idx = [ref + o for o in WINDOW]
        tf = np.stack([np.linalg.inv(transforms[ref]) @ transforms[i]
                       for i in idx])
        job = dict(out_path=str(out_dir / f"{ref:06d}.txt"),
                   window_frames=WINDOW,
                   get_points=(lambda k, idx=idx: pts[idx[k]]),
                   get_masks=(lambda k, idx=idx: masks[idx[k]]),
                   transforms=tf, p2=P2, img_hw=(H, W))
        if with_ids:
            job["frame_ids"] = idx
        jobs.append(job)
    return jobs


@pytest.mark.parametrize("with_ids", [True, False])
def test_label_frames_matches_jax(labelers, tmp_path, with_ids):
    lab_j, lab_t = labelers
    dir_j, dir_t = tmp_path / "jax", tmp_path / "torch"
    assert lab_j.label_frames(_jobs(dir_j, with_ids)) == 3
    assert lab_t.label_frames(_jobs(dir_t, with_ids)) == 3
    n_rows = 0
    for ref in (3, 4, 5):
        text_t = (dir_t / f"{ref:06d}.txt").read_text()
        assert text_t == (dir_j / f"{ref:06d}.txt").read_text()
        n_rows += len(text_t.splitlines())
    assert n_rows >= 3
    # skip-if-exists: nothing is written the second time
    assert lab_t.label_frames(_jobs(dir_t, with_ids)) == 0
    # the stream in groups of two gives the files of per-group calls
    dir_s, dir_g = tmp_path / "stream", tmp_path / "groups"
    assert lab_t.label_frames_stream(_jobs(dir_s, with_ids),
                                     group_size=2) == 3
    jobs_g = _jobs(dir_g, with_ids)
    assert lab_t.label_frames(jobs_g[:2]) == 2
    assert lab_t.label_frames(jobs_g[2:]) == 1
    for ref in (3, 4, 5):
        assert (dir_s / f"{ref:06d}.txt").read_text() == \
            (dir_g / f"{ref:06d}.txt").read_text()


def test_copied_host_modules_equal_jax():
    """candidates, lomm and aggregation are numpy copies: the same arrays
    on the two-car scene."""
    pts, masks, transforms = _make_scene((TRUE_POSE, SECOND_POSE), seed=3)
    cands_j, cands_t = [], []
    for k in range(len(WINDOW)):
        cands_j.append(jcand.extract_candidates(
            pts[k], P2, (H, W), masks[k], transforms[k]))
        cands_t.append(candidates.extract_candidates(
            pts[k], P2, (H, W), masks[k], transforms[k]))
        np.testing.assert_array_equal(cands_t[k]["locations"],
                                      cands_j[k]["locations"])
        for a, b in zip(cands_t[k]["points"], cands_j[k]["points"]):
            np.testing.assert_array_equal(a, b)
    tracks_j = jlomm.greedy_track(cands_j, WINDOW, 10.0)
    tracks_t = lomm.greedy_track(cands_t, WINDOW, 10.0)
    jlomm.classify_all(tracks_j, method="both5")
    lomm.classify_all(tracks_t, method="both5")
    assert len(tracks_t) == len(tracks_j) == 2
    for a, b in zip(tracks_t, tracks_j):
        assert a.frames == b.frames and a.moving == b.moving
        np.testing.assert_array_equal(np.stack(a.locations),
                                      np.stack(b.locations))
    kept_j, points_j, _ = jagg.aggregate_tracks(tracks_j, transforms, WINDOW,
                                                min_points=400)
    kept_t, points_t, _ = aggregation.aggregate_tracks(
        tracks_t, transforms, WINDOW, min_points=400)
    assert len(kept_t) == len(kept_j) == 2
    for a, b in zip(points_t, points_j):
        np.testing.assert_array_equal(a, b)
    # the padded batch, with the seeded subsampling to max_points
    batch_j = jagg.build_car_batch(kept_j, points_j, WINDOW, 4, 512)
    batch_t = aggregation.build_car_batch(kept_t, points_t, WINDOW, 4, 512)
    batch_d = aggregation.build_car_batch(kept_t, points_t, WINDOW, 4, 512,
                                          device="cpu")
    for name in batch_t._fields:
        got = getattr(batch_t, name)
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, np.asarray(getattr(batch_j, name)))
        np.testing.assert_array_equal(getattr(batch_d, name).numpy(), got)
    np.testing.assert_array_equal(
        aggregation.cap_points(points_t[0], 100),
        jagg.cap_points(points_j[0], 100))


def _labelers_for(cfg_j, cfg_t):
    bank = dict(num_points=N_TEMPLATE)
    return (jpipe.PseudoLabeler(cfg_j, bank=JTemplateBank.default(**bank)),
            pipeline.PseudoLabeler(cfg_t, bank=TemplateBank.default(**bank),
                                   device="cpu"))


@pytest.mark.parametrize("flag", [
    "use_ensemble_filter", "use_scale_detector", "use_dimensions_estimation",
    "use_robust_optimization", "extract_pedestrians"])
def test_left_out_flags_raise(flag):
    """Named for what the stages did before they were ported: none raises
    now.  Each stage labels the one-car scene through ``label_frame`` as
    the JAX labeller does (x, y, z, theta within 1e-4, the dimensions
    within 1e-5, the points equal); ``extract_pedestrians`` with a
    standing person in the reference frame and its mask also gives the
    JAX labeller's Pedestrian row, key for key."""
    cfg_j, cfg_t = _configs(**{flag: True})
    lab_j, lab_t = _labelers_for(cfg_j, cfg_t)
    scene = _make_scene()
    kw = {}
    if flag == "extract_pedestrians":
        rng = np.random.default_rng(5)
        person = np.stack([rng.uniform(2.8, 3.2, 400),
                           rng.uniform(0.0, 1.66, 400),
                           rng.uniform(8.8, 9.2, 400)], 1)
        pts, masks_, transforms = scene
        pts = list(pts)
        pts[3] = np.concatenate([pts[3], person]).astype(np.float32)
        scene = (pts, masks_, transforms)
        hom = np.hstack([person, np.ones((len(person), 1))]) @ P2.T
        uv = np.rint(hom[:, :2] / hom[:, 2:3]).astype(int)
        mask = np.zeros((H, W), bool)
        mask[uv[:, 1], uv[:, 0]] = True
        kw["ped_masks"] = [scipy.ndimage.binary_dilation(mask)]
    rows_j = lab_j.label_frame(WINDOW, 3, **_frame_args(scene), **kw)
    rows_t = lab_t.label_frame(WINDOW, 3, **_frame_args(scene), **kw)
    assert [r["cls"] for r in rows_t] == [r["cls"] for r in rows_j]
    peds = [(a, b) for a, b in zip(rows_t, rows_j)
            if a["cls"] == "Pedestrian"]
    assert len(peds) == (flag == "extract_pedestrians")
    for a, b in peds:
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    cars_t = [r for r in rows_t if r["cls"] == "Car"]
    cars_j = [r for r in rows_j if r["cls"] == "Car"]
    assert len(cars_t) == 1
    _assert_cars_match(cars_t, cars_j, dims_atol=1e-5)
    if flag == "use_scale_detector":
        # the scale grid and the box reducer measured the car
        assert (cars_t[0]["l"], cars_t[0]["w"]) != (3.88, 1.63)


def test_scale_detector_on_real_lidar_matches_jax(tmp_path):
    """``use_pseudo_lidar=False`` with the scale detector: each standing
    car's points are re-gathered from the window's live scans
    (``extract_scale_lidar_scans``), in ``label_frame`` and in
    ``label_frames``; the cars and the label files of the JAX labeller."""
    cfg_j, cfg_t = _configs(use_pseudo_lidar=False, use_scale_detector=True)
    lab_j, lab_t = _labelers_for(cfg_j, cfg_t)
    scene = _make_scene()
    cars_t = lab_t.label_frame(WINDOW, 3, **_frame_args(scene))
    _assert_cars_match(cars_t, lab_j.label_frame(WINDOW, 3,
                                                 **_frame_args(scene)),
                       dims_atol=1e-5)
    assert len(cars_t) == 1
    dir_j, dir_t = tmp_path / "jax", tmp_path / "torch"
    assert lab_j.label_frames(_jobs(dir_j, True)[:1]) == 1
    assert lab_t.label_frames(_jobs(dir_t, True)[:1]) == 1
    assert (dir_t / "000003.txt").read_text() == \
        (dir_j / "000003.txt").read_text() != ""


def test_ensemble_and_dimensions_through_label_frames_match_jax(tmp_path):
    """The outlier ensemble and the dimension estimator in the batched
    path (``label_frames`` hands ``label_from_cars`` the fitted poses):
    the JAX labeller's label files."""
    cfg_j, cfg_t = _configs(use_ensemble_filter=True,
                            use_dimensions_estimation=True)
    lab_j, lab_t = _labelers_for(cfg_j, cfg_t)
    dir_j, dir_t = tmp_path / "jax", tmp_path / "torch"
    assert lab_j.label_frames(_jobs(dir_j, True)[:2]) == 2
    assert lab_t.label_frames(_jobs(dir_t, True)[:2]) == 2
    for ref in (3, 4):
        text = (dir_t / f"{ref:06d}.txt").read_text()
        assert text == (dir_j / f"{ref:06d}.txt").read_text() != ""


def test_other_left_out_paths_raise(labelers, tmp_path):
    """Named for what it checked before these paths were ported: the
    strict hidden-standing check on real LiDAR and the ``chamfer`` loss
    kind each label the scene as the JAX labeller does (the car, seen in
    the reference scan, kept), and the card is the default."""
    lab_j, lab_t = labelers
    lab_sj, lab_st = _labelers_for(*_configs(use_pseudo_lidar=False,
                                             strict_hidden_standing=True))
    scene = _make_scene()
    cars_t = lab_st.label_frame(WINDOW, 3, **_frame_args(scene))
    _assert_cars_match(cars_t, lab_sj.label_frame(WINDOW, 3,
                                                  **_frame_args(scene)))
    assert len(cars_t) == 1
    lab_cj, lab_ct = _labelers_for(
        dataclasses.replace(lab_j.cfg,
                            fit=JFitConfig(**GRID, loss_function="chamfer")),
        dataclasses.replace(lab_t.cfg,
                            fit=FitConfig(**GRID, loss_function="chamfer")))
    scene = _make_scene()
    cars_t = lab_ct.label_frame(WINDOW, 3, **_frame_args(scene))
    _assert_cars_match(cars_t, lab_cj.label_frame(WINDOW, 3,
                                                  **_frame_args(scene)))
    assert len(cars_t) == 1
    if not torch.cuda.is_available():
        # the card unless the caller asks for the CPU: no quiet fallback
        with pytest.raises(RuntimeError, match="cuda"):
            pipeline.PseudoLabeler(lab_t.cfg)


def test_load_labeler_state_checks_shapes(labelers):
    _, lab_t = labelers
    with pytest.raises(ValueError, match="occ_kernels"):
        convert.load_labeler_state(
            lab_t, lab_t.bank.points, np.zeros((8, 3, 3, 3), np.float32),
            lab_t.memb_kernels.numpy())


def test_cars_cache_written(labelers, tmp_path):
    """cars_cache_dir persists the fitted cars (sowa/cache.py)."""
    _, lab_t = labelers
    cfg = dataclasses.replace(lab_t.cfg, cars_cache_dir=str(tmp_path / "cc"))
    lab = pipeline.PseudoLabeler(
        cfg, bank=TemplateBank.default(num_points=N_TEMPLATE), device="cpu")
    cars = lab.label_and_write(str(tmp_path / "000003.txt"), WINDOW, 3,
                               **_frame_args(_make_scene()))
    from monosowa_tpu_torch.sowa import cache
    back = cache.load_optimized_cars(str(tmp_path / "cc"), "000003")
    assert len(back) == len(cars) == 1
    assert back[0]["theta"] == pytest.approx(cars[0]["theta"])
    np.testing.assert_array_equal(back[0]["points"], cars[0]["points"])
    np.testing.assert_array_equal(back[0]["mask"], cars[0]["mask"])


def test_mask_bbox():
    m = np.zeros((10, 20), bool)
    m[2:5, 3:9] = True
    np.testing.assert_array_equal(pipeline.mask_bbox(m), [3, 2, 8, 4])
    np.testing.assert_array_equal(pipeline.mask_bbox(m), jpipe.mask_bbox(m))
