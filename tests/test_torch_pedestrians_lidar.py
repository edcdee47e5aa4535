"""Pedestrian labels (``sowa/pedestrians.py``), real-LiDAR scans
(``kittiio/velodyne.py``, ``kittiio/raw_calib.py``) and the strict
hidden-standing check through the port's labeller and CLI, against the
JAX package's, on the CPU.

The labeller's scene: the one-car scene of ``tests/test_torch_labeler.py``
plus a standing car hidden in the reference frame (neither scanned nor
masked there), a car at 80 m and a standing person, written as velodyne
``.bin`` scans and read back through ``load_velo_scan`` and
``velo_to_cam``.  Tolerance: the JAX package's cars and rows (x / y / z and
theta within 1e-4, everything else equal) and label files equal line for
line."""


import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch
import yaml
from PIL import Image

from monosowa_tpu.kittiio import raw_calib as jraw_calib
from monosowa_tpu.kittiio import velodyne as jvelodyne
from monosowa_tpu.ops.geometry import rot_y
from monosowa_tpu.sowa import aggregation as jagg
from monosowa_tpu.sowa import cli as jcli
from monosowa_tpu.sowa import pedestrians as jped
from monosowa_tpu_torch.kittiio import raw_calib, read_label_file, velodyne
from monosowa_tpu_torch.sowa import aggregation, cli, masks, pedestrians

from test_torch_labeler import (H, N_TEMPLATE, P2, TRUE_POSE, WINDOW,
                                _assert_cars_match, _configs, _labelers_for)

torch.set_num_threads(1)    # the suite runs six worker processes at once

# KITTI-style velodyne -> cam2 axis permutation with a lever arm (the JAX
# package's tests/test_velodyne_branch.py)
T_CAM_VELO = np.array([[0, -1, 0, 0.06],
                       [0, 0, -1, -0.08],
                       [1, 0, 0, -0.27],
                       [0, 0, 0, 1]], np.float64)
W = 400
HIDDEN_POSE = dict(x=-3.0, y=0.9, z=19.0, theta=1.2)
FAR_POSE = dict(x=20.0, y=0.9, z=80.0, theta=0.3)
PED = dict(x=3.0, z=8.0, h=1.7, r=0.25)      # standing on the ground y 1.66
REF = 3


def _person_cloud(rng, n=600):
    """A vertical cylinder of points (up is -y in the camera frame)."""
    ang = rng.uniform(0, 2 * np.pi, n)
    rad = PED["r"] * np.sqrt(rng.uniform(0, 1, n))
    y = 1.66 - rng.uniform(0, PED["h"], n)
    return np.stack([PED["x"] + rad * np.cos(ang), y,
                     PED["z"] + rad * np.sin(ang)], 1)


def _project_mask(pts, iterations=3):
    hom = np.hstack([pts, np.ones((len(pts), 1))]) @ P2.T
    uv = np.rint(hom[:, :2] / hom[:, 2:3]).astype(int)
    ok = ((uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0)
          & (uv[:, 1] < H))
    mask = np.zeros((H, W), bool)
    mask[uv[ok, 1], uv[ok, 0]] = True
    return scipy.ndimage.binary_dilation(mask, iterations=iterations)


def _car(pose, bank_points):
    rot = np.asarray(rot_y(jnp.float32(pose["theta"])))
    return bank_points @ rot.T + np.array([pose["x"], pose["y"], pose["z"]])


@pytest.fixture(scope="module")
def lidar_scene(tmp_path_factory):
    """Seven velodyne scans (ego +0.5 m a frame) of the visible car, the
    hidden car (absent from frame REF's scan and masks), the far car, the
    person and the ground (none on the hidden car's lot); masks of the
    cars a frame, the person's mask of frame REF."""
    from monosowa_tpu.sowa.templates import TemplateBank as JTemplateBank

    root = tmp_path_factory.mktemp("velodyne")
    rng = np.random.default_rng(0)
    local = JTemplateBank.default(num_points=N_TEMPLATE).points[0]
    cars_ref = {"visible": _car(TRUE_POSE, local),
                "hidden": _car(HIDDEN_POSE, local),
                "far": _car(FAR_POSE, local)}
    person_ref = _person_cloud(rng)
    inv = np.linalg.inv(T_CAM_VELO)
    paths, masks_f, transforms = [], [], []
    for k in range(len(WINDOW)):
        t_cur_to_ref = np.eye(4)
        t_cur_to_ref[2, 3] = (k - REF) * -0.5
        transforms.append(t_cur_to_ref)
        t_ref_to_cur = np.linalg.inv(t_cur_to_ref)

        def to_cur(p):
            return p @ t_ref_to_cur[:3, :3].T + t_ref_to_cur[:3, 3]

        clouds, frame_masks = [], []
        for name, car in cars_ref.items():
            if name == "hidden" and k == REF:
                continue
            cur = to_cur(car) + rng.normal(scale=0.02, size=car.shape)
            clouds.append(cur)
            frame_masks.append(_project_mask(cur))
        person = to_cur(person_ref)
        if k == REF:
            ped_mask = _project_mask(person, iterations=1)
        ground = np.stack([rng.uniform(-8, 8, 800), np.full(800, 1.66),
                           rng.uniform(4, 30, 800)], 1)
        # the hidden car's lot is out of the scanner's sight in every
        # frame: no ground point within 5 m of its centre
        lot = to_cur(np.array([[HIDDEN_POSE["x"], 0.0, HIDDEN_POSE["z"]]]))
        ground = ground[np.hypot(ground[:, 0] - lot[0, 0],
                                 ground[:, 2] - lot[0, 2]) > 5.0]
        cam = np.concatenate(clouds + [person, ground])
        velo = (np.hstack([cam, np.ones((len(cam), 1))]) @ inv.T)[:, :3]
        velo = np.hstack([velo, rng.uniform(0, 1, (len(velo), 1))])
        path = str(root / f"{k:010d}.bin")
        velo.astype(np.float32).tofile(path)
        paths.append(path)
        masks_f.append(frame_masks)
    return paths, masks_f, np.stack(transforms), ped_mask


def _scan(path):
    return velodyne.velo_to_cam(velodyne.load_velo_scan(path), T_CAM_VELO)


def _frame_args(scene):
    paths, masks_f, transforms, _ = scene
    return dict(get_points=lambda k: _scan(paths[k]),
                get_masks=lambda k: masks_f[k], transforms=transforms,
                p2=P2, img_hw=(H, W))


def test_velodyne_io_matches_jax(lidar_scene):
    """load_velo_scan and velo_to_cam (with and without the z > 0 cut)
    give the JAX package's arrays, bit for bit."""
    paths = lidar_scene[0]
    got, want = velodyne.load_velo_scan(paths[0]), \
        jvelodyne.load_velo_scan(paths[0])
    assert got.shape[1] == 4 and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    behind = np.concatenate([got, [[-5.0, 0.0, 0.0, 0.1]]]).astype(
        np.float32)
    for filt in (True, False):
        a = velodyne.velo_to_cam(behind, T_CAM_VELO, filter_points=filt)
        b = jvelodyne.velo_to_cam(behind, T_CAM_VELO, filter_points=filt)
        assert a.dtype == np.float32 and len(a) == len(got) + (not filt)
        np.testing.assert_array_equal(a, b)


def test_raw_calib_matches_jax(tmp_path):
    (tmp_path / "calib_imu_to_velo.txt").write_text(
        "R: 1 0 0 0 1 0 0 0 1\nT: -0.8 0.3 -0.7\n")
    (tmp_path / "calib_velo_to_cam.txt").write_text(
        "calib_time: 15-Mar-2012 11:37:16\n"
        "R: 0 -1 0 0 0 -1 1 0 0\nT: -0.01 -0.07 -0.27\n")
    (tmp_path / "calib_cam_to_cam.txt").write_text(
        "R_rect_00: 1 0 0 0 1 0 0 0 1\n"
        "P_rect_02: 720 0 600 45.0 0 720 180 0 0 0 1 0\n")
    got = raw_calib.load_raw_calib(str(tmp_path))
    want = jraw_calib.load_raw_calib(str(tmp_path))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


def test_hidden_standing_keep_real_matches_jax():
    rng = np.random.default_rng(0)
    car = rng.normal(size=(3000, 3)).astype(np.float32) + [0, 1, 12]
    near = np.concatenate([car[:5] + 0.05,
                           rng.uniform(-20, 20, (3000, 3))]).astype(
                               np.float32)
    far = rng.uniform(30, 60, (500, 3)).astype(np.float32)
    seen = []
    for scan in (near, far, None, np.zeros((0, 3), np.float32)):
        for strict in (False, True):
            got = aggregation.hidden_standing_keep_real(car, scan,
                                                        strict=strict)
            assert got == jagg.hidden_standing_keep_real(car, scan,
                                                         strict=strict)
            seen.append(got)
    assert seen == [True, True, True, False, True, False, True, False]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("z", [76.0, 85.0, 150.0])
def test_hidden_standing_keep_real_far_car_matches_jax(z, dtype):
    """A car beyond the 75 m gate, a scan of 5,000 points around it and
    one probe 0.09-0.11 m from a car point, where float32's expanded
    distances decide: the port, which measures only the scan points near
    the car, answers as the JAX package, which measures all of them."""
    rng = np.random.default_rng(int(z))
    car = (rng.normal(size=(500, 3)) * [0.9, 0.5, 2.0]
           + [3.0, 1.0, z]).astype(dtype)
    back = np.stack([rng.uniform(-40, 40, 5000), rng.uniform(-2, 3, 5000),
                     rng.uniform(0, z + 20, 5000)], 1)
    d_back = np.sqrt(((back[:, None] - car[None].astype(np.float64)) ** 2)
                     .sum(-1)).min(1)
    back = back[d_back > 0.12]
    answers = []
    for _ in range(100):
        v = rng.normal(size=3)
        probe = car[rng.integers(len(car))] + v / np.linalg.norm(v) \
            * rng.uniform(0.09, 0.11)
        scan = np.concatenate([back, probe[None]]).astype(np.float32)
        rng.shuffle(scan)
        got = aggregation.hidden_standing_keep_real(car, scan, strict=True)
        assert got == jagg.hidden_standing_keep_real(car, scan, strict=True)
        answers.append(got)
    assert 10 < sum(answers) < 90


def test_extract_pedestrian_labels_matches_jax(lidar_scene):
    """The person's row from the reference scan and its mask (and a mask
    with too few points, and none): the JAX package's dicts."""
    paths, _, _, ped_mask = lidar_scene
    pts = _scan(paths[REF])
    small = np.zeros((H, W), bool)
    small[:3, :3] = True
    for masks_ in ([ped_mask, small], [], [small]):
        got = pedestrians.extract_pedestrian_labels(pts, P2, (H, W), masks_)
        want = jped.extract_pedestrian_labels(pts, P2, (H, W), masks_)
        assert len(got) == len(want) == (1 if masks_ and masks_[0] is
                                         ped_mask else 0)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                np.testing.assert_array_equal(g[k], w[k])
    row = got and got[0] or pedestrians.extract_pedestrian_labels(
        pts, P2, (H, W), [ped_mask])[0]
    assert abs(row["x"] - PED["x"]) < 0.3 and abs(row["z"] - PED["z"]) < 0.4
    cfg = pedestrians.PedestrianConfig(min_points=10 ** 6)
    assert pedestrians.extract_pedestrian_labels(pts, P2, (H, W),
                                                 [ped_mask], cfg) == []


def _split(rows):
    return ([r for r in rows if r["cls"] == "Car"],
            [r for r in rows if r["cls"] == "Pedestrian"])


def _lidar_labelers(strict=True):
    """The two labellers on real LiDAR with pedestrians; cars without a
    reference mask are written (``skip_non_visible`` off), so the hidden
    car shows in the files where the strict check keeps it."""
    return _labelers_for(*_configs(use_pseudo_lidar=False,
                                   strict_hidden_standing=strict,
                                   extract_pedestrians=True,
                                   skip_non_visible=False))


def _assert_rows_match(rows_t, rows_j):
    cars_t, peds_t = _split(rows_t)
    cars_j, peds_j = _split(rows_j)
    assert [r["cls"] for r in rows_t] == [r["cls"] for r in rows_j]
    _assert_cars_match(cars_t, cars_j)
    for g, w in zip(peds_t, peds_j):
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    return cars_t, peds_t


def _nearest(cars, pose):
    return min(np.hypot(c["x"] - pose["x"], c["z"] - pose["z"])
               for c in cars)


def test_label_frame_real_lidar_matches_jax(lidar_scene):
    """label_frame on the velodyne scans with use_pseudo_lidar=False,
    strict_hidden_standing and extract_pedestrians: the JAX labeller's
    rows.  The hidden car is dropped (kept without the strict check, the
    reference's quirk), the car at 80 m kept, one Pedestrian row within
    0.5 m of the person."""
    lab_j, lab_t = _lidar_labelers()
    ped_masks = [lidar_scene[3]]
    rows_t = lab_t.label_frame(WINDOW, REF, ped_masks=ped_masks,
                               **_frame_args(lidar_scene))
    rows_j = lab_j.label_frame(WINDOW, REF, ped_masks=ped_masks,
                               **_frame_args(lidar_scene))
    cars, peds = _assert_rows_match(rows_t, rows_j)
    assert len(cars) == 2 and len(peds) == 1
    assert _nearest(cars, TRUE_POSE) < 0.5 and _nearest(cars, FAR_POSE) < 1.0
    assert _nearest(cars, HIDDEN_POSE) > 5.0
    assert _nearest(peds, PED) < 0.5
    loose_j, loose_t = _lidar_labelers(strict=False)
    rows_t = loose_t.label_frame(WINDOW, REF, ped_masks=ped_masks,
                                 **_frame_args(lidar_scene))
    cars, _ = _assert_rows_match(rows_t, loose_j.label_frame(
        WINDOW, REF, ped_masks=ped_masks, **_frame_args(lidar_scene)))
    assert len(cars) == 3 and _nearest(cars, HIDDEN_POSE) < 1.0


def test_label_frames_real_lidar_matches_jax(lidar_scene, tmp_path):
    """label_frames (with and without frame ids) and label_and_write on
    the same scans: the JAX labeller's label files, line for line."""
    lab_j, lab_t = _lidar_labelers()
    args = _frame_args(lidar_scene)
    texts = []
    for ids in (False, True):
        for lab, tag in ((lab_j, "jax"), (lab_t, "torch")):
            job = dict(out_path=str(tmp_path / f"{tag}_{ids}" / "000003.txt"),
                       window_frames=WINDOW, ped_masks=[lidar_scene[3]],
                       **args)
            if ids:
                job["frame_ids"] = list(range(len(WINDOW)))
            assert lab.label_frames([job]) == 1
            texts.append(open(job["out_path"]).read())
    assert texts[0] == texts[1] == texts[2] == texts[3]
    labels = read_label_file(str(tmp_path / "torch_True" / "000003.txt"))
    assert sorted(labels.names) == ["Car", "Car", "Pedestrian"]
    out = str(tmp_path / "write" / "000003.txt")
    lab_t.label_and_write(out, WINDOW, REF, ped_masks=[lidar_scene[3]],
                          **args)
    assert open(out).read() == texts[0]


# ---------------------------------------------------------------------------
# the CLI's optimization with a pedestrians/ cache (the JAX package's
# tests/test_pedestrians.py:74 scene), port and JAX driver
# ---------------------------------------------------------------------------


def _kitti_tree(root):
    """One frame: a car, a person and the ground in lidar_raw/, the car's
    mask in masks_raw/ and the person's in pedestrians/."""
    from monosowa_tpu.sowa.templates import TemplateBank as JTemplateBank

    kitti = root / "kitti"
    (kitti / "training" / "image_2").mkdir(parents=True)
    (kitti / "training" / "calib").mkdir(parents=True)
    fid = "000000"
    Image.fromarray(np.zeros((H, W, 3), np.uint8)).save(
        kitti / "training" / "image_2" / f"{fid}.png")
    p2_line = " ".join(str(v) for v in P2.reshape(-1))
    (kitti / "training" / "calib" / f"{fid}.txt").write_text(
        "\n".join([f"P{i}: {p2_line}" for i in range(4)]
                  + ["R0_rect: 1 0 0 0 1 0 0 0 1",
                     "Tr_velo_to_cam: 1 0 0 0 0 1 0 0 0 0 1 0",
                     "Tr_imu_to_velo: 1 0 0 0 0 1 0 0 0 0 1 0"]) + "\n")
    rng = np.random.default_rng(0)
    car = _car(TRUE_POSE, JTemplateBank.default().points[0])
    car = np.tile(car, (2, 1)) + rng.normal(scale=0.02, size=(2000, 3))
    person = _person_cloud(rng)
    ground = np.stack([rng.uniform(-8, 8, 800), np.full(800, 1.66),
                       rng.uniform(4, 30, 800)], 1)
    pts = np.concatenate([car, person, ground]).astype(np.float32)
    for tag in ("torch", "jax"):
        cache = root / tag
        (cache / "lidar_raw").mkdir(parents=True)
        np.savez_compressed(cache / "lidar_raw" / f"{fid}.npz", points=pts)
        masks.save_masks(str(cache / "masks_raw"), fid,
                         [_project_mask(car, 1)], (H, W))
        masks.save_masks(str(cache / "pedestrians"), fid,
                         [_project_mask(person, 1)], (H, W))
    return kitti, fid


@pytest.mark.parametrize("merged", [False, True])
def test_cli_optimization_with_pedestrians_matches_jax(tmp_path, merged):
    """`--action optimization` with extract_pedestrians over the
    pedestrians/ cache: a Car and a Pedestrian row, the JAX driver's label
    file; with ``merged`` the frame first goes through
    frames_aggregation and is fitted from its merged-cars cache."""
    kitti, fid = _kitti_tree(tmp_path)
    for tag, main, dev in (("torch", cli.main, ["--device", "cpu"]),
                           ("jax", jcli.main, [])):
        conf = {"paths": {"kitti_path": str(kitti),
                          "merged_frames_path": str(tmp_path / tag),
                          "labels_path": str(tmp_path / tag / "labels")},
                "frames_creation": {"nscans_before": 0, "nscans_after": 0,
                                    "extract_pedestrians": True},
                "optimization": {"opt_param1_iters": 16,
                                 "opt_param2_iters": 16,
                                 "opt_param3_iters": 24,
                                 "opt_fine_iters": 60},
                "filtering": {"lidar_threshold_during_optim": 400,
                              "max_points_per_car": 1024}}
        path = tmp_path / f"{tag}.yaml"
        path.write_text(yaml.safe_dump(conf))
        actions = (["frames_aggregation"] if merged else []) + \
            ["optimization"]
        for action in actions:
            assert main(["--config", str(path), "--action", action]
                        + dev) == 0
    text = (tmp_path / "torch" / "labels" / f"{fid}.txt").read_text()
    assert text == (tmp_path / "jax" / "labels" / f"{fid}.txt").read_text()
    objs = read_label_file(str(tmp_path / "torch" / "labels" / f"{fid}.txt"))
    assert sorted(objs.names) == ["Car", "Pedestrian"]
    pi = objs.names.index("Pedestrian")
    assert abs(objs.pos[pi][0] - PED["x"]) < 0.3
    assert abs(objs.ry[pi]) < 0.01
