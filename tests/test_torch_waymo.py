"""The port's raw-Waymo path (``sowa/waymo2d.py``, ``sowa/stitching.py``,
``sowa/tracker2d.py``, the ``loftr`` / ``vit_tracker`` zoo kinds and
``sowa/cli.py``'s ``WaymoSegmentDriver``) against the JAX package's, on
the CPU.

Scenes: ``tests/test_waymo2d.py``'s (its shrunk pair layout, true
homographies, the moving square), ``tests/test_stitching_tracking.py``'s
homography data, ``tests/test_waymo2d_e2e.py``'s seven-frame scene for the
whole 2D path, and ``tests/test_cli_waymo.py``'s segment on disk for the
four CLI actions (ORB through cv2 in both packages).  Bars: every
function's output equal to the JAX function's (canvases, masks, slots,
homographies, switch decisions, tracks, Track fields, cache files, label
files); the live Mask2Former's canvas masks (the zoo's tiny
configuration on the stitched canvases) with the same queries and tracks,
at most 1e-3 of their pixels flipped (logits at 0 within float32
rounding; 83 of 6,854,400 packed mask bits, 1.2e-5, printed)."""

import dataclasses
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from monosowa_tpu.models import efficientloftr as jelo
from monosowa_tpu.models import vit_tracker as jvt
from monosowa_tpu.sowa import aggregation as jagg
from monosowa_tpu.sowa import cli as jcli
from monosowa_tpu.sowa import lomm as jlomm
from monosowa_tpu.sowa import masks as jmasks
from monosowa_tpu.sowa import pipeline as jpipe
from monosowa_tpu.sowa import stitching as jstitch
from monosowa_tpu.sowa import tracker2d as jtr
from monosowa_tpu.sowa import waymo2d as jw
from monosowa_tpu.sowa import zoo as jzoo
from monosowa_tpu.sowa.fitting import FitConfig as JFitConfig
from monosowa_tpu_torch.config import Config
from monosowa_tpu_torch.convert import zoo_params
from monosowa_tpu_torch.kittiio.labels import write_pseudo_label_file
from monosowa_tpu_torch.models import mask2former as m2f
from monosowa_tpu_torch.sowa import aggregation, cli, lomm, pipeline
from monosowa_tpu_torch.sowa import stitching, tracker2d, waymo2d, zoo
from monosowa_tpu_torch.sowa.fitting import FitConfig

from test_stitching_tracking import _apply_h
from test_torch_swin_mask2former import CFG as M2F_CFG
from test_torch_swin_mask2former import car_bias
from test_torch_vit_tracker import SMALL, random_tree
from test_waymo2d import (LAYOUT, _moving_square_sequence, _OracleMatcher,
                          _true_homos)
from test_waymo2d_e2e import LAYOUT as E2E_LAYOUT
from test_waymo2d_e2e import N_FRAMES, TRUE_POSE, _build_scene

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(1)    # the suite runs six worker processes at once

CPU = "cpu"
# the share of a live network's mask pixels that may flip against the JAX
# forward: pixels whose random-weight logit sits at 0 within float32
# rounding
MASK_FLIP_BAR = 1e-3
GRID = {"opt_param1_iters": 16, "opt_param2_iters": 16,
        "opt_param3_iters": 24, "opt_fine_iters": 60}


def template_cpu():
    return tracker2d.TemplateMatchTracker(device=CPU)


def np_(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else t


# ---------------------------------------------------------------- waymo2d


def test_stitch_pair_and_unwarp():
    rng = np.random.default_rng(0)
    img_a = rng.uniform(0, 255, (LAYOUT.cam_h, LAYOUT.cam_w, 3))
    img_b = rng.uniform(0, 255, (LAYOUT.cam_h, LAYOUT.cam_w, 3))
    homos = _true_homos()
    for ltr in (True, False):
        np.testing.assert_array_equal(
            np_(waymo2d.stitch_pair(img_a, img_b, homos[1], ltr, LAYOUT,
                                    CPU)),
            jw.stitch_pair(img_a, img_b, homos[1], ltr, LAYOUT))
    u8 = [rng.integers(0, 256, (LAYOUT.cam_h, LAYOUT.cam_w, 3),
                       dtype=np.uint8) for _ in range(2)]
    persp = homos[2].copy()
    persp[:2, :2] += [[0.05, 0.02], [-0.03, 0.04]]
    persp[2, :2] = [3e-4, -2e-4]
    np.testing.assert_array_equal(
        np_(waymo2d.stitch_pair(u8[0], u8[1], persp, False, LAYOUT, CPU)),
        jw.stitch_pair(u8[0], u8[1], persp, False, LAYOUT))
    grey = [u[..., :1] for u in u8]
    np.testing.assert_array_equal(
        np_(waymo2d.stitch_pair(grey[0], grey[1], persp, True, LAYOUT,
                                CPU)),
        jw.stitch_pair(grey[0], grey[1], persp, True, LAYOUT))

    ys, xs = LAYOUT.paste_slice(True)
    tx, ty = int(homos[1][0, 2]), int(homos[1][1, 2])
    masks_ = []
    for box in ((ys.start + 10, ys.start + 20, xs.start + 30, xs.start + 50),
                (ty + 20, ty + 30, tx + 10, tx + 40)):
        m = np.zeros(LAYOUT.canvas_hw, bool)
        m[box[0]:box[1], box[2]:box[3]] = True
        masks_.append(m)
    seam = masks_[0] | masks_[1]
    for m in masks_ + [seam]:
        for hs in (homos, [persp] * 4):
            for z in range(4):
                got, slot = waymo2d.pano_mask_to_camera(m, z, hs, LAYOUT,
                                                        CPU)
                want, wslot = jw.pano_mask_to_camera(m, z, hs, LAYOUT)
                assert slot == wslot
                np.testing.assert_array_equal(got, want)
                both = waymo2d.pano_mask_to_both_cameras(m, z, hs, LAYOUT,
                                                         CPU)
                jboth = jw.pano_mask_to_both_cameras(m, z, hs, LAYOUT)
                assert [s for _, s in both] == [s for _, s in jboth]
                for (a, _), (b, _) in zip(both, jboth):
                    np.testing.assert_array_equal(a, b)


def test_side_padding_and_crop():
    side = np.ones((LAYOUT.side_h, LAYOUT.cam_w, 3))
    np.testing.assert_array_equal(
        waymo2d.pad_side_image(side, LAYOUT), jw.pad_side_image(side, LAYOUT))
    np.testing.assert_array_equal(
        np_(waymo2d.pad_side_image(torch.from_numpy(side), LAYOUT)),
        jw.pad_side_image(side, LAYOUT))
    homos = _true_homos()
    mask = np.zeros(LAYOUT.canvas_hw, bool)
    tx, ty = int(homos[0][0, 2]), int(homos[0][1, 2])
    pad_rows = LAYOUT.cam_h - LAYOUT.side_h
    mask[ty + pad_rows + 5:ty + pad_rows + 15, tx + 10:tx + 30] = True
    got, slot = waymo2d.pano_mask_to_camera(mask, 0, homos, LAYOUT, CPU)
    want, wslot = jw.pano_mask_to_camera(mask, 0, homos, LAYOUT)
    assert slot == wslot == 0
    np.testing.assert_array_equal(got, want)


def test_estimate_pair_homographies():
    homos = _true_homos()
    imgs = [np.zeros((LAYOUT.side_h if s in (0, 4) else LAYOUT.cam_h,
                      LAYOUT.cam_w, 3)) for s in range(5)]
    got = waymo2d.estimate_pair_homographies(
        lambda i: imgs, 3, _OracleMatcher(homos, LAYOUT), LAYOUT)
    want = jw.estimate_pair_homographies(
        lambda i: imgs, 3, _OracleMatcher(homos, LAYOUT), LAYOUT)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_track_pair_sequence():
    stitched, det_masks, homos = _moving_square_sequence()
    got = waymo2d.track_pair_sequence(stitched, det_masks, homos, LAYOUT,
                                      template_cpu, device=CPU)
    want = jw.track_pair_sequence(stitched, det_masks, homos, LAYOUT)
    assert got == want and len(got) == 1


@pytest.mark.parametrize("pair", range(4))
def test_check_for_image_switch(pair):
    homos = _true_homos()
    h, w = LAYOUT.canvas_hw
    boxes = [[10, 40, 16, 12], [w - 40, 30, 16, 12], [w // 2, 20, 30, 20],
             [LAYOUT.cam_w - 20, 25, 40, 30], [-5, -3, 20, 10],
             [w - LAYOUT.cam_w + 5, 12, 50, 40], [3, 50, 100, 30]]
    for bbox in boxes:
        for rdy in (0, 1):
            for sw in (0, 2):
                got = waymo2d.check_for_image_switch(
                    bbox, pair, rdy, sw, homos, LAYOUT, device=CPU)
                want = jw.check_for_image_switch(bbox, pair, rdy, sw, homos,
                                                 LAYOUT)
                assert got == want, (bbox, rdy, sw)


def test_stitch_frame_none_homography_and_union():
    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 256, ((LAYOUT.side_h if s in (0, 4)
                                   else LAYOUT.cam_h), LAYOUT.cam_w, 3),
                         dtype=np.uint8) for s in range(5)]
    homos = _true_homos()
    homos[0] = None
    got = waymo2d.stitch_frame(imgs, homos, LAYOUT, device=CPU)
    want = jw.stitch_frame(imgs, homos, LAYOUT)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np_(g), w)

    homos = _true_homos()
    ys, xs = LAYOUT.paste_slice(True)
    mask = np.zeros(LAYOUT.canvas_hw, bool)
    mask[ys.start + 10:ys.start + 30, xs.start + 10:xs.start + 30] = True
    tx, ty = int(homos[1][0, 2]), int(homos[1][1, 2])
    mask[ty + 10:ty + 20, tx + 10:tx + 20] = True
    fused = np.repeat(np.array([[1.0, 0.0, 5.0, 1, 15, 15],
                                [1.2, 0.0, 5.2, 2, 15, 15],
                                [9.0, 9.0, 9.0, 1, 100, 70]]), 6, axis=0)
    args = ([[(0, 1, 0)]], [[[], [mask], [], []]], [fused], homos,
            np.tile(np.eye(4), (1, 1, 1)), 0, [0], LAYOUT, 10)
    got = waymo2d.tracks_from_2d(*args, device=CPU)
    want = jw.tracks_from_2d(*args)
    assert_tracks_equal(got, want)
    assert len(got[0].points[0]) == 12


def assert_tracks_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.frames == b.frames and a.moving == b.moving
        for x, y in zip(a.locations + a.points, b.locations + b.points):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(a.masks, b.masks):
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(x, y)


def test_gather_points_transforms_iou():
    mask = np.zeros((20, 30), bool)
    mask[5:10, 10:20] = True
    lidar = np.array([[1.0, 2.0, 3.0, 1, 12, 7], [4.0, 5.0, 6.0, 1, 2, 2],
                      [7.0, 8.0, 9.0, 2, 12, 7], [1.5, 2.5, 3.5, 1, 29, 19]])
    for slot in range(5):
        np.testing.assert_array_equal(
            waymo2d.gather_mask_points(mask, slot, lidar),
            jw.gather_mask_points(mask, slot, lidar))
    poses = np.tile(np.eye(4), (3, 1, 1))
    poses[0, 0, 3], poses[2, :3, 3] = -2.0, [2.0, 0.3, -0.1]
    for ref in range(3):
        np.testing.assert_array_equal(
            waymo2d.camera_transforms_from_vehicle(poses, ref),
            jw.camera_transforms_from_vehicle(poses, ref))
    for b1, b2 in (([0, 0, 10, 10], [0, 0, 10, 10]),
                   ([0, 0, 10, 10], [5, 3, 7, 9])):
        assert waymo2d._iou_xywh(b1, b2) == jw._iou_xywh(b1, b2)
    m = np.zeros((9, 12), bool)
    m[2:5, 3:9] = True
    np.testing.assert_array_equal(waymo2d.mask_bbox_xywh(m),
                                  jw.mask_bbox_xywh(m))
    assert waymo2d.mask_bbox_xywh(np.zeros((3, 3), bool)) is None


# -------------------------------------------------------------- stitching


def test_homography_math():
    rng = np.random.default_rng(1)
    h_true = np.array([[1.0, 0.0, 50.0], [0.0, 1.0, -20.0], [0, 0, 1.0]])
    src = rng.uniform(0, 1000, (100, 2))
    dst = _apply_h(h_true, src) + rng.normal(scale=0.3, size=(100, 2))
    dst[:30] += rng.uniform(50, 200, (30, 2))
    np.testing.assert_array_equal(stitching.homography_dlt(src, dst),
                                  jstitch.homography_dlt(src, dst))
    np.testing.assert_array_equal(stitching.transfer_error(h_true, src, dst),
                                  jstitch.transfer_error(h_true, src, dst))
    got = stitching.ransac_homography(src, dst, iterations=300)
    want = jstitch.ransac_homography(src, dst, iterations=300)
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0], want[0])
    frames = []
    for f in range(4):
        s = rng.uniform(0, 1000, (40, 2))
        noise = 0.2 if f != 2 else 30.0
        frames.append((s, _apply_h(h_true, s)
                       + rng.normal(scale=noise, size=(40, 2))))
    np.testing.assert_array_equal(
        stitching.select_best_homography(frames, iterations=200),
        jstitch.select_best_homography(frames, iterations=200))
    assert stitching.PanoramaLayout().pano_shape == \
        jstitch.PanoramaLayout().pano_shape
    np.testing.assert_array_equal(stitching.PanoramaLayout().center_offset(),
                                  jstitch.PanoramaLayout().center_offset())


def test_panorama_warps():
    rng = np.random.default_rng(2)
    lay = stitching.PanoramaLayout(height_pad=10, width_pad=30, cam_w=120,
                                   cam_h=80)
    jlay = jstitch.PanoramaLayout(height_pad=10, width_pad=30, cam_w=120,
                                  cam_h=80)
    pano = rng.integers(0, 256, lay.pano_shape + (3,), dtype=np.uint8)
    side = rng.integers(0, 256, (80, 120, 3), dtype=np.uint8)
    h = np.array([[0.95, 0.03, -70.5], [0.01, 1.02, 3.25],
                  [2e-4, 1e-4, 1.0]])
    np.testing.assert_array_equal(
        np_(stitching.warp_into_panorama(pano, side, h, lay, CPU)),
        jstitch.warp_into_panorama(pano, side, h, jlay))
    mp = rng.uniform(size=lay.pano_shape) > 0.5
    np.testing.assert_array_equal(
        np_(stitching.unwarp_mask(mp, h, lay, (80, 120), CPU)),
        jstitch.unwarp_mask(mp, h, jlay, (80, 120)))


def test_orb_backend_and_its_absence(monkeypatch):
    rng = np.random.default_rng(4)
    a = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
    b = np.roll(a, 7, axis=1)
    got = stitching.OrbMatcherBackend().match(a, b)
    want = jstitch.OrbMatcherBackend().match(a, b)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="backends.matcher: loftr"):
        stitching.OrbMatcherBackend()


def test_host_tracking_helpers():
    boxes = [np.array(b, float) for b in ([0, 0, 10, 10], [2, 2, 12, 12],
                                          [20, 20, 30, 35], [1, 0, 9, 10])]
    assert tracker2d.filter_overlapping_detections(boxes) == \
        jtr.filter_overlapping_detections(boxes)
    for a in boxes:
        for b in boxes:
            assert tracker2d.box_iou(a, b) == jtr.box_iou(a, b)
    for x in (10.0, 1800.0, 2400.0, 4500.0):
        box = np.array([x, 0, x + 30, 40])
        assert tracker2d.camera_of_box(box, 5340) == \
            jtr.camera_of_box(box, 5340)
    stitched, det_masks, _ = _moving_square_sequence()
    frames = [s[1] for s in stitched]
    per = [[waymo2d.mask_bbox_xywh(m) + [0, 0, 0, 0] for m in f[1]]
           for f in det_masks]
    per = [[np.array([b[0], b[1], b[0] + b[2], b[1] + b[3]]) for b in f]
           for f in per]
    init = [per[0][0]]
    got = tracker2d.track_masks(frames, init, per, template_cpu)
    want = jtr.track_masks(frames, init, per)
    assert [o.matched_mask_idx for o in got] == \
        [o.matched_mask_idx for o in want]
    for a, b in zip(got, want):
        for x, y in zip(a.boxes, b.boxes):
            np.testing.assert_array_equal(x, y)


# ------------------------------------------------------ whole 2D path


def test_whole_2d_path_matches_jax():
    """``tests/test_waymo2d_e2e.py``'s scene: tracking, the LiDAR gather,
    moving / standing, aggregation and the fit (a cut grid), the label
    file equal to the JAX package's; the standing car within 0.35 m."""
    poses, lidars, det_masks, stitched, homos, ref = _build_scene()
    cars2d = waymo2d.track_pair_sequence(stitched, det_masks, homos,
                                         E2E_LAYOUT, template_cpu,
                                         device=CPU)
    assert cars2d == jw.track_pair_sequence(stitched, det_masks, homos,
                                            E2E_LAYOUT)
    window = list(range(-ref, N_FRAMES - ref))
    t_cam = waymo2d.camera_transforms_from_vehicle(np.stack(poses), ref)
    tracks = waymo2d.tracks_from_2d(cars2d, det_masks, lidars, homos, t_cam,
                                    ref, window, E2E_LAYOUT, device=CPU)
    jtracks = jw.tracks_from_2d(cars2d, det_masks, lidars, homos, t_cam,
                                ref, window, E2E_LAYOUT)
    assert_tracks_equal(tracks, jtracks)
    lomm.classify_all(tracks, method="both5")
    jlomm.classify_all(jtracks, method="both5")
    kept, points, ref_masks = aggregation.aggregate_tracks(
        tracks, t_cam, window, keep_k=10, min_points=400)
    jkept, jpoints, jref = jagg.aggregate_tracks(
        jtracks, t_cam, window, keep_k=10, min_points=400)
    grid = dict(n_dx=16, n_dz=16, n_theta=24, n_theta_fine=60)
    common = dict(nscans_before=ref, nscans_after=N_FRAMES - 1 - ref,
                  max_cars=4, max_points=1024, min_standing_points=400)
    cars = pipeline.PseudoLabeler(
        pipeline.PipelineConfig(**common, fit=FitConfig(**grid)),
        device=CPU).label_from_cars(kept, points, ref_masks, window)
    jcars = jpipe.PseudoLabeler(
        jpipe.PipelineConfig(**common, fit=JFitConfig(fine_chunk=12,
                                                      **grid))
    ).label_from_cars(jkept, jpoints, jref, window)
    assert len(cars) == len(jcars) == 1
    assert cars[0]["x"] == pytest.approx(TRUE_POSE["x"], abs=0.35)
    assert cars[0]["z"] == pytest.approx(TRUE_POSE["z"], abs=0.35)
    assert label_text(cars) == label_text(jcars)


def label_text(cars) -> str:
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "l.txt")
        write_pseudo_label_file(path, cars)
        with open(path) as f:
            return f.read()


# ------------------------------------------------------------------- CLI


@pytest.fixture(scope="module")
def segment(tmp_path_factory):
    """``tests/test_cli_waymo.py``'s segment (its images, LiDAR, poses and
    precomputed pair-canvas masks) and a config per package."""
    from PIL import Image

    root = tmp_path_factory.mktemp("waymo_torch")
    seg_dir = root / "segments" / "seg-000"
    poses, lidars, det_masks, _, homos, ref = _build_scene()
    lay = E2E_LAYOUT
    rng = np.random.default_rng(7)
    for slot in range(5):
        d = seg_dir / f"camera_{slot}"
        d.mkdir(parents=True)
        hh = lay.side_h if slot in (0, 4) else lay.cam_h
        for i in range(N_FRAMES):
            img = rng.integers(0, 40, (hh, lay.cam_w, 3), dtype=np.uint8)
            if slot == 2:
                ys_slot, xs_slot = lay.paste_slice(True)
                img[det_masks[i][1][0][ys_slot, xs_slot]] = 230
            Image.fromarray(img).save(d / f"{i:06d}.png")
    (seg_dir / "lidar").mkdir()
    for i in range(N_FRAMES):
        np.savez_compressed(seg_dir / "lidar" / f"{i:06d}.npz",
                            points=lidars[i])
    np.save(seg_dir / "poses.npy", np.stack(poses))
    return dict(root=root, det_masks=det_masks, homos=homos, ref=ref)


def seg_config(seg, tag, extra=None, masks_raw=True):
    root = seg["root"]
    cache = root / f"cache_{tag}"
    if masks_raw and not (cache / "masks_raw").exists():
        for i in range(N_FRAMES):
            for z in range(4):
                jmasks.save_masks(str(cache / "masks_raw" / "seg-000"),
                                  f"{i:06d}_{z}", seg["det_masks"][i][z],
                                  E2E_LAYOUT.canvas_hw)
    cfg = {"paths": {"waymo_path": str(root / "segments"),
                     "merged_frames_path": str(cache) + "/",
                     "labels_path": str(root / f"labels_{tag}") + "/"},
           "image_stitching": {"height_pxl_pad": E2E_LAYOUT.height_pad,
                               "width_pxl_pad": E2E_LAYOUT.width_pad},
           "frames_creation": {"nscans_before": N_FRAMES // 2,
                               "nscans_after": N_FRAMES // 2,
                               "nscans_transformation_range": N_FRAMES // 2},
           "optimization": dict(GRID),
           "filtering": {"lidar_threshold_during_optim": 400,
                         "max_points_per_car": 1024}}
    for k, v in (extra or {}).items():
        cfg.setdefault(k, {}).update(v)
    path = root / f"config_{tag}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path), cache, root / f"labels_{tag}"


def run_both(seg, action, tag="", extra=None, masks_raw=True):
    out = {}
    for pkg, main, dev in (("t", cli.main, ["--device", CPU]),
                           ("j", jcli.main, [])):
        conf, cache, labels = seg_config(seg, pkg + tag, extra, masks_raw)
        assert main(["--config", conf, "--dataset", "waymo", "--action",
                     action] + dev) == 0
        out[pkg] = (cache, labels)
    return out


def assert_npz_equal(a, b):
    with np.load(a, allow_pickle=True) as za, \
            np.load(b, allow_pickle=True) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            x, y = za[k], zb[k]
            if x.dtype == object:
                assert len(x) == len(y)
                for u, v in zip(x, y):
                    np.testing.assert_array_equal(u, v)
            else:
                np.testing.assert_array_equal(x, y)


def test_cli_homographies(segment):
    out = run_both(segment, "homographies")
    files = [c / "homographies" / "seg-000.npz" for c, _ in out.values()]
    assert_npz_equal(*files)
    # skip-if-exists
    conf = seg_config(segment, "t")[0]
    assert cli.WaymoSegmentDriver(
        cli.load_config(conf), cli.PipelineFlags("homographies"),
        device=CPU).run(None, None) == 0


def test_cli_mask_tracking_and_cross_reads(segment):
    """The JAX CLI test's flow: the true homographies in the cache, the
    precomputed masks, then mask_tracking; the detandtracked caches equal.
    Each package's optimization then reads the other's caches: the label
    files equal."""
    for pkg in ("t", "j"):
        _, cache, _ = seg_config(segment, pkg)
        hp = cache / "homographies" / "seg-000.npz"
        hp.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(hp, homos=np.stack(segment["homos"]))
    out = run_both(segment, "mask_tracking")
    files = [c / "detandtracked" / "seg-000.npz" for c, _ in out.values()]
    assert_npz_equal(*files)
    with np.load(files[0], allow_pickle=True) as z:
        assert max(len(o) for o in z["cars"]) == N_FRAMES

    ref = segment["ref"]
    labels = {}
    for pkg, main, dev, cache_of in (
            ("t", cli.main, ["--device", CPU], "j"),
            ("j", jcli.main, [], "t")):
        conf, _, lab = seg_config(segment, pkg + "x")
        cfg = yaml.safe_load(open(conf))
        cfg["paths"]["merged_frames_path"] = str(out[cache_of][0]) + "/"
        with open(conf, "w") as f:
            yaml.safe_dump(cfg, f)
        (lab / "seg-000").mkdir(parents=True, exist_ok=True)
        for i in range(N_FRAMES):
            if i != ref:
                (lab / "seg-000" / f"{i:06d}.txt").write_text("")
        assert main(["--config", conf, "--dataset", "waymo", "--action",
                     "optimization"] + dev) == 0
        labels[pkg] = (lab / "seg-000" / f"{ref:06d}.txt").read_text()
    assert labels["t"] == labels["j"] and labels["t"].startswith("Car ")


def test_cli_transformations(segment):
    out = run_both(segment, "transformations", tag="tr")
    dirs = [c / "transformations" / "seg-000" for c, _ in out.values()]
    names = sorted(os.listdir(dirs[0]))
    assert names == sorted(os.listdir(dirs[1])) and len(names) == N_FRAMES
    for n in names:
        np.testing.assert_array_equal(np.load(dirs[0] / n),
                                      np.load(dirs[1] / n))


def test_cli_optimization(segment):
    """Each package's chain on its own caches: true homographies, masks,
    tracking, then the reference frame's label file (the other frames
    pre-marked done); the files equal and the car at the truth."""
    ref = segment["ref"]
    for pkg in ("t", "j"):
        _, cache, lab = seg_config(segment, pkg + "o")
        hp = cache / "homographies" / "seg-000.npz"
        hp.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(hp, homos=np.stack(segment["homos"]))
        (lab / "seg-000").mkdir(parents=True, exist_ok=True)
        for i in range(N_FRAMES):
            if i != ref:
                (lab / "seg-000" / f"{i:06d}.txt").write_text("")
    run_both(segment, "mask_tracking", tag="o")
    out = run_both(segment, "optimization", tag="o")
    texts = [(lab / "seg-000" / f"{ref:06d}.txt").read_text()
             for _, lab in out.values()]
    assert texts[0] == texts[1]
    from monosowa_tpu_torch.kittiio import read_label_file
    lab = read_label_file(str(out["t"][1] / "seg-000" / f"{ref:06d}.txt"))
    assert lab.names[0] == "Car"
    assert lab.pos[0][0] == pytest.approx(TRUE_POSE["x"], abs=0.5)
    assert lab.pos[0][2] == pytest.approx(TRUE_POSE["z"], abs=0.5)


def test_cli_live_mask2former_tracking(segment):
    """``backends.mask: mask2former`` (the zoo's tiny configuration, seeded
    weights, a car bias) on the stitched canvases instead of a masks_raw
    cache: the detandtracked caches equal."""
    tree = zoo_params(m2f.Mask2Former(M2F_CFG, device=CPU, seed=0))
    canvas = jw.stitch_frame(
        [np.asarray(__import__("PIL.Image").Image.open(
            segment["root"] / "segments" / "seg-000" / f"camera_{s}"
            / "000000.png")) for s in range(5)],
        segment["homos"], E2E_LAYOUT)[1]
    hw = (64, 192)
    tree["transformer"]["class_predictor"]["bias"][2] += car_bias(
        tree, M2F_CFG, canvas, hw, quantile=0.5, target=0.5)
    ckpt = str(segment["root"] / "m2f.npz")
    zoo.save_checkpoint(ckpt, "mask2former", tree, M2F_CFG)
    extra = {"backends": {"mask": "mask2former", "mask_checkpoint": ckpt,
                          "mask_input_hw": list(hw)},
             "filtering": {"score_detectron_thresh": 0.3}}
    for pkg in ("t", "j"):
        _, cache, _ = seg_config(segment, pkg + "live", extra,
                                 masks_raw=False)
        hp = cache / "homographies" / "seg-000.npz"
        hp.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(hp, homos=np.stack(segment["homos"]))
    out = run_both(segment, "mask_tracking", tag="live", extra=extra,
                   masks_raw=False)
    files = [c / "detandtracked" / "seg-000.npz" for c, _ in out.values()]
    flips, pixels = 0, 0
    with np.load(files[0], allow_pickle=True) as za, \
            np.load(files[1], allow_pickle=True) as zb:
        assert sorted(za.files) == sorted(zb.files)
        assert any(k.startswith("m_") for k in za.files)
        for k in za.files:
            if k.startswith("m_"):
                a = np.unpackbits(za[k], axis=-1)
                b = np.unpackbits(zb[k], axis=-1)
                flips += int((a != b).sum())
                pixels += a.size
            elif k == "cars":
                assert [o.tolist() for o in za[k]] == \
                    [o.tolist() for o in zb[k]]
            else:
                np.testing.assert_array_equal(za[k], zb[k])
    print(json.dumps({"live_canvas_mask_flips": flips, "pixels": pixels}))
    assert flips <= MASK_FLIP_BAR * pixels


# ------------------------------------------------------------------- zoo


def test_zoo_loads_jax_loftr_and_tracker_checkpoints(tmp_path):
    """Checkpoints written by the JAX package load through the port's zoo
    (the backends give the JAX backends' answers), and the port's load in
    the JAX package."""
    transformers = pytest.importorskip("transformers")
    from test_torch_efficientloftr import tiny_hf_config

    hf_cfg = tiny_hf_config()
    torch.manual_seed(0)
    stock = transformers.EfficientLoFTRForKeypointMatching(hf_cfg).eval()
    jcfg = jelo.config_from_hf_efficientloftr(hf_cfg)
    ltree = jelo.import_hf_efficientloftr(stock.state_dict(), jcfg)
    lpath = str(tmp_path / "loftr.npz")
    jzoo.save_checkpoint(lpath, "loftr", ltree, jcfg)
    tcfg = jvt.ViTTrackerConfig(**SMALL)
    ttree = random_tree(jvt.init_tracker_params(0, tcfg))
    tpath = str(tmp_path / "tracker.npz")
    jzoo.save_checkpoint(tpath, "vit_tracker", ttree, tcfg)

    conf = {"backends": {"matcher": "loftr", "matcher_checkpoint": lpath,
                         "matcher_input_hw": [64, 64], "tracker": "vit",
                         "tracker_checkpoint": tpath}}
    matcher = zoo.matcher_backend(Config(conf), device=CPU)
    jmatcher = jzoo.matcher_backend(jcli.Config(conf))
    assert dataclasses.asdict(matcher.cfg) == dataclasses.asdict(jmatcher.cfg)
    rng = np.random.default_rng(3)
    a = rng.integers(0, 255, (100, 130, 3), dtype=np.uint8)
    b = rng.integers(0, 255, (100, 130, 3), dtype=np.uint8)
    for g, w in zip(matcher.match(a, b), jmatcher.match(a, b)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=130e-5)

    make, jmake = zoo.tracker_factory(Config(conf), device=CPU), \
        jzoo.tracker_factory(jcli.Config(conf))
    frames = [rng.integers(0, 255, (120, 200, 3), dtype=np.uint8)
              for _ in range(3)]
    t1, t2, jt = make(), make(), jmake()
    assert t1.model is t2.model and t1 is not t2
    for t in (t1, jt):
        t.init(frames[0], [40, 50, 30, 20])
    for f in frames[1:]:
        np.testing.assert_allclose(t1.track(f), jt.track(f), atol=1e-3)
    assert t2._box is None

    # the port's checkpoints in the JAX package
    ppath = str(tmp_path / "port_tracker.npz")
    zoo.save_checkpoint(ppath, "vit_tracker",
                        zoo_params(t1.model), t1.cfg)
    kind, tree, cfg = jzoo.load_checkpoint(ppath)
    assert kind == "vit_tracker" and cfg == tcfg
    x = rng.normal(size=(1, 64, 64, 3)).astype(np.float32)
    z = rng.normal(size=(1, 32, 32, 3)).astype(np.float32)
    tok = rng.normal(size=(1, 2, 32)).astype(np.float32)
    want = jvt.tracker_forward(ttree, jnp.asarray(z), jnp.asarray(x),
                               jnp.asarray(tok), tcfg)
    got = jvt.tracker_forward(tree, jnp.asarray(z), jnp.asarray(x),
                              jnp.asarray(tok), tcfg)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert zoo.tracker_factory(Config({}), device=CPU)().device == CPU
    with pytest.raises(ValueError):
        zoo.matcher_backend(Config({"backends": {"matcher": "sift"}}))
