"""The port's CLI (``sowa/cli.py``) and the modules it reads caches with
(``sowa/depth.py``, ``sowa/masks.py``, ``sowa/transforms.py``,
``ops/geometry.backproject_depth``) against the JAX package's, on the CPU.

The CLI cases build KITTI-layout directories (images, calib,
``masks_raw/``, ``transformations/``, ``depth_maps/<frame>/<offset>.npz``
or ``lidar_raw/<frame>/pcds/<offset>.npz``) of the synthetic 96 x 160
scene, as ``--dataset kitti``, ``kitti360`` (frame ids
``<sequence>_<number>``, ``data_poses/<sequence>/cam0_to_world.txt`` with
a gap) and ``waymo_converted`` (``Cur_pose`` calib rows) lay them out,
and run both CLIs over them: the cache files must be equal (the
transformations, candidates and merged cars), the label files must agree
(names equal, x, y, z, theta and the dimensions within 1e-4).  Depth
functions on random depth maps: equal."""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import jax.numpy as jnp

from monosowa_tpu.ops import geometry as jgeometry
from monosowa_tpu.sowa import cli as jcli
from monosowa_tpu.sowa import depth as jdepth
from monosowa_tpu.sowa import masks as jmasks
from monosowa_tpu.sowa import transforms as jtransforms
from monosowa_tpu_torch.kittiio import read_label_file
from monosowa_tpu_torch.ops import geometry
from monosowa_tpu_torch.sowa import cli, depth, masks, transforms

torch.set_num_threads(1)    # the suite runs six worker processes at once

H, W = 96, 160
FU = 120.0
P2 = np.array([[FU, 0, W / 2, 0], [0, FU, H / 2, 0], [0, 0, 1, 0]])
WINDOW = 2
FIDS = ["000010", "000011"]


def _random_depth(seed):
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.5, 80.0, (H, W)).astype(np.float32)
    d[rng.random((H, W)) < 0.1] = 0.0
    return d


class _FixedDepth:
    """A live depth backend that answers every image with one map."""

    def __init__(self, dmap):
        self.dmap, self.calls = dmap, 0

    def predict_depth(self, image):
        self.calls += 1
        return self.dmap


def test_depth_functions_match_jax(tmp_path):
    d = _random_depth(0)
    f = [np.float32(v) for v in (P2[0, 0], P2[1, 1], P2[0, 2], P2[1, 2])]
    np.testing.assert_array_equal(
        geometry.backproject_depth(torch.from_numpy(d),
                                   *map(torch.tensor, f)).numpy(),
        np.asarray(jgeometry.backproject_depth(jnp.asarray(d), *f)))
    np.testing.assert_array_equal(
        depth.lift_depth_to_points(
            torch.from_numpy(d), *map(torch.tensor, f),
            torch.tensor(np.float32(0.12))).numpy(),
        np.asarray(jdepth.lift_depth_to_points(
            jnp.asarray(d), *f, jnp.float32(0.12))))
    for canonical in (True, False):
        got = depth.pseudo_lidar_from_depth(d, P2, canonical, device="cpu")
        want = jdepth.pseudo_lidar_from_depth(d, P2, canonical)
        assert got.dtype == np.float32 and (got[:, 2] > 0).all()
        np.testing.assert_array_equal(got, want)
    # the cache: written by the port, read by both; skip-if-exists
    frames = ["a", "b"]
    maps = [d, _random_depth(1)]
    assert depth.generate_pseudo_lidar_cache(frames, maps, P2,
                                             str(tmp_path), device="cpu") == 2
    assert depth.generate_pseudo_lidar_cache(frames, maps, P2,
                                             str(tmp_path), device="cpu") == 0
    for fr in frames:
        p = str(tmp_path / f"{fr}.npz")
        np.testing.assert_array_equal(depth.load_pseudo_lidar(p),
                                      jdepth.load_pseudo_lidar(p))
    assert depth.load_pseudo_lidar(str(tmp_path / "none.npz")) is None
    # a live backend: its predict_depth of each image is lifted
    live = _FixedDepth(_random_depth(3))
    image = np.zeros((H, W, 3), np.uint8)
    assert depth.generate_pseudo_lidar_cache(
        ["c"], [image], P2, str(tmp_path / "t"), backend=live,
        device="cpu") == 1
    assert jdepth.generate_pseudo_lidar_cache(
        ["c"], [image], P2, str(tmp_path / "j"), backend=live) == 1
    np.testing.assert_array_equal(
        depth.load_pseudo_lidar(str(tmp_path / "t" / "c.npz")),
        jdepth.load_pseudo_lidar(str(tmp_path / "j" / "c.npz")))
    assert live.calls == 2
    np.savez_compressed(tmp_path / "m.npz", depth=d)
    np.testing.assert_array_equal(
        depth.CachedDepthBackend(str(tmp_path)).predict_depth_for("m"),
        jdepth.CachedDepthBackend(str(tmp_path)).predict_depth_for("m"))
    assert depth.CachedDepthBackend(str(tmp_path)).predict_depth_for(
        "none") is None
    assert (depth.MAX_DEPTH, depth.CANONICAL_FOCAL) == (
        jdepth.MAX_DEPTH, jdepth.CANONICAL_FOCAL)


def test_cache_io_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    ms = [rng.random((H, W)) < 0.3 for _ in range(3)]
    masks.save_masks(str(tmp_path / "t"), "f", ms, (H, W))
    jmasks.save_masks(str(tmp_path / "j"), "f", ms, (H, W))
    masks.save_masks(str(tmp_path / "t"), "empty", [], (H, W))
    for a, b in zip(masks.load_masks(str(tmp_path / "j"), "f"),
                    jmasks.load_masks(str(tmp_path / "t"), "f")):
        np.testing.assert_array_equal(a, b)
    assert masks.load_masks(str(tmp_path / "t"), "empty") == []
    assert masks.load_masks(str(tmp_path / "t"), "none") is None
    for m in ms + [np.zeros((H, W), bool)]:
        np.testing.assert_array_equal(masks.mask_box(m), jmasks.mask_box(m))
    t = rng.normal(size=(9, 4, 4))
    transforms.save_window_transforms(str(tmp_path / "tf"), "f", t)
    assert transforms.transforms_cache_path("c", "f") == \
        jtransforms.transforms_cache_path("c", "f")
    back = jtransforms.load_window_transforms(str(tmp_path / "tf"), "f")
    np.testing.assert_array_equal(back, t)
    np.testing.assert_array_equal(
        transforms.slice_window(t, 4, 2, 1),
        jtransforms.slice_window(t, 4, 2, 1))
    assert transforms.load_window_transforms(str(tmp_path), "x") is None


def _scene_depth(global_frame):
    """Metric depth and one mask of a car box that drifts by a pixel a
    frame."""
    rng = np.random.default_rng(global_frame)
    d = np.full((H, W), 300.0, np.float32)
    vrel = np.maximum(np.arange(H)[:, None] - H / 2, 1)
    d = np.minimum(d, (FU * 1.6 / vrel).astype(np.float32)
                   * np.ones((H, W), np.float32))
    x1 = 40 + global_frame % 3
    m = np.zeros((H, W), bool)
    m[20:34, x1:x1 + 30] = True
    d[m] = 12.0 + rng.normal(scale=0.01, size=int(m.sum())).astype(
        np.float32)
    return d, [m]


@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    kitti, cache = root / "kitti", root / "cache"
    (kitti / "training" / "image_2").mkdir(parents=True)
    (kitti / "training" / "calib").mkdir(parents=True)
    p2_line = " ".join(str(v) for v in P2.reshape(-1))
    calib = "\n".join([f"P{i}: {p2_line}" for i in range(4)]
                      + ["R0_rect: 1 0 0 0 1 0 0 0 1",
                         "Tr_velo_to_cam: 1 0 0 0 0 1 0 0 0 0 1 0",
                         "Tr_imu_to_velo: 1 0 0 0 0 1 0 0 0 0 1 0"]) + "\n"
    rng_full = 4
    for fid in FIDS:
        Image.fromarray(np.zeros((H, W, 3), np.uint8)).save(
            kitti / "training" / "image_2" / f"{fid}.png")
        (kitti / "training" / "calib" / f"{fid}.txt").write_text(calib)
        full = np.tile(np.eye(4), (2 * rng_full + 1, 1, 1))
        full[:, 2, 3] = np.arange(-rng_full, rng_full + 1) * 0.002
        transforms.save_window_transforms(str(cache / "transformations"),
                                          fid, full)
        for k in range(-WINDOW, WINDOW + 1):
            d, ms = _scene_depth(int(fid) + k)
            name = fid if k == 0 else f"{fid}{k:+d}"
            masks.save_masks(str(cache / "masks_raw"), name, ms, (H, W))
            dm = cache / "depth_maps" / fid
            dm.mkdir(parents=True, exist_ok=True)
            # canonical depth: metric * 1000 / fx
            np.savez_compressed(dm / f"{k:+d}.npz",
                                depth=d * (depth.CANONICAL_FOCAL / FU))
    return root


def _config(root, tag):
    cfg = {"paths": {"kitti_path": str(root / "kitti"),
                     "merged_frames_path": str(root / "cache"),
                     "labels_path": str(root / tag)},
           "general": {"frames_per_batch": 2},
           "frames_creation": {"nscans_before": WINDOW,
                               "nscans_after": WINDOW},
           "optimization": {"opt_param1_iters": 12, "opt_param2_iters": 12,
                            "opt_param3_iters": 8, "opt_fine_iters": 24,
                            "max_cars_per_frame": 8},
           "filtering": {"lidar_threshold_during_optim": 150,
                         "max_points_per_car": 512}}
    path = root / f"{tag}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_optimization_matches_jax_cli(kitti_dir):
    """Both CLIs over one cache with depth_maps/: the port on the CPU in
    bank mode; the same label files."""
    assert jcli.main(["--config", _config(kitti_dir, "jax"),
                      "--action", "optimization"]) == 0
    assert cli.main(["--config", _config(kitti_dir, "torch"),
                     "--action", "optimization", "--device", "cpu"]) == 0
    n_cars = 0
    for fid in FIDS:
        a = read_label_file(str(kitti_dir / "torch" / f"{fid}.txt"))
        b = read_label_file(str(kitti_dir / "jax" / f"{fid}.txt"))
        assert a.names == b.names
        n_cars += len(a.names)
        if len(a.names):
            np.testing.assert_allclose(a.pos, b.pos, atol=1e-4)
            np.testing.assert_allclose(a.ry, b.ry, atol=1e-4)
    assert n_cars == len(FIDS)
    # skip-if-exists: a second run writes nothing
    mtime = os.path.getmtime(kitti_dir / "torch" / f"{FIDS[0]}.txt")
    drv = cli.KittiObjectDriver(
        cli.load_config(_config(kitti_dir, "torch")),
        cli.PipelineFlags("optimization"), device="cpu")
    assert drv.run(None, None) == 0
    assert mtime == os.path.getmtime(kitti_dir / "torch" / f"{FIDS[0]}.txt")
    job = drv._optimize_job(FIDS[0])
    assert job["frame_ids"] == [int(FIDS[0]) + k
                                for k in range(-WINDOW, WINDOW + 1)]
    d, _ = _scene_depth(int(FIDS[0]) - 1)
    np.testing.assert_allclose(job["get_depth"](1), d, rtol=1e-6)
    assert drv._image_hw(FIDS[0]) == (H, W)


def test_config_and_arguments_match_jax(kitti_dir):
    conf = cli.load_config(_config(kitti_dir, "args"))
    got = cli.pipeline_config_from(conf)
    want = jcli.pipeline_config_from(jcli.load_config(
        _config(kitti_dir, "args")))
    for f in ("nscans_before", "max_cars", "max_points",
              "min_standing_points", "nms_iou", "use_pseudo_lidar",
              "device_bank", "bank_slots", "bank_refit_cap"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.fit.n_theta_fine == want.fit.n_theta_fine == 24
    args = cli.parse_args(["--config", "c", "--action", "optimization"])
    assert args.device is None and args.dataset == "kitti"
    assert cli.parse_args(["--config", "c", "--action", "optimization",
                           "--device", "cpu"]).device == "cpu"


def test_config_without_pyyaml_reads_json_only(kitti_dir, tmp_path,
                                               monkeypatch):
    """Without PyYAML a JSON config reads as PyYAML reads it; a YAML
    config raises an ImportError that names PyYAML."""
    path = _config(kitti_dir, "args")
    with open(path) as f:
        want = yaml.safe_load(f)
    as_json = tmp_path / "args.json"
    as_json.write_text(json.dumps(want))
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert cli.load_config(str(as_json)).to_dict() == want
    with pytest.raises(ImportError, match="PyYAML"):
        cli.load_config(path)


SEQ ="2013_05_28_drive_0000_sync"
NUMBERS = (10, 11)
RNG = 3           # nscans_transformation_range: one more than WINDOW
POSE_GAP = 14     # in frame 11's +-RNG window, outside every +-WINDOW


def _pose(i):
    """The ego camera's pose at frame i: forward along z, turning."""
    t = np.eye(4)
    c, s = np.cos(0.01 * i), np.sin(0.01 * i)
    t[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    t[:3, 3] = [0.01 * i, 0.0, 0.3 * i]
    return t


def _fids(dataset):
    if dataset in ("kitti360", "all"):
        return [f"{SEQ}_{n:010d}" for n in NUMBERS]
    return [f"{n:06d}" for n in NUMBERS]


def _layout(root, dataset):
    """The scene's two reference frames laid out for ``dataset``: images,
    calib (with ``Cur_pose`` rows for waymo_converted, frames 7-14),
    ``data_poses/`` (kitti360 / all: frames 0-15 but POSE_GAP), and under
    ``cache/`` the window's ``masks_raw/`` and ``lidar_raw/<fid>/pcds/``.
    Returns the config path of each package's copy of the cache."""
    kitti, cache = root / "kitti", root / "cache"
    (kitti / "training" / "image_2").mkdir(parents=True)
    (kitti / "training" / "calib").mkdir(parents=True)
    p2_line = " ".join(str(v) for v in P2.reshape(-1))
    calib = ([f"P{i}: {p2_line}" for i in range(4)]
             + ["R0_rect: 1 0 0 0 1 0 0 0 1",
                "Tr_velo_to_cam: 0 -1 0 0.1 0 0 -1 0.2 1 0 0 -0.3",
                "Tr_imu_to_velo: 1 0 0 0 0 1 0 0 0 0 1 0"])
    if dataset == "waymo_converted":
        for i in range(7, 15):
            pose = " ".join(str(v) for v in _pose(i).reshape(-1))
            (kitti / "training" / "calib" / f"{i:06d}.txt").write_text(
                "\n".join(calib + [f"Cur_pose: {pose}"]) + "\n")
    if dataset in ("kitti360", "all"):
        poses = root / "k360" / "data_poses" / SEQ
        poses.mkdir(parents=True)
        (poses / "cam0_to_world.txt").write_text("".join(
            f"{i} " + " ".join(f"{v:.12f}" for v in _pose(i).reshape(-1))
            + "\n" for i in range(16) if i != POSE_GAP))
    for n, fid in zip(NUMBERS, _fids(dataset)):
        Image.fromarray(np.zeros((H, W, 3), np.uint8)).save(
            kitti / "training" / "image_2" / f"{fid}.png")
        cal = kitti / "training" / "calib" / f"{fid}.txt"
        if not cal.exists():
            cal.write_text("\n".join(calib) + "\n")
        pcds = cache / "lidar_raw" / fid / "pcds"
        pcds.mkdir(parents=True)
        for k in range(-WINDOW, WINDOW + 1):
            d, ms = _scene_depth(n + k)
            name = fid if k == 0 else f"{fid}{k:+d}"
            masks.save_masks(str(cache / "masks_raw"), name, ms, (H, W))
            np.savez(pcds / f"{k:+d}.npz",
                     points=depth.pseudo_lidar_from_depth(
                         d, P2, canonical=False, device="cpu"))
    confs = []
    for tag in ("t", "j"):
        shutil.copytree(cache, root / f"cache_{tag}")
        conf = yaml.safe_load(open(_config(root, f"labels_{tag}")))
        conf["paths"]["merged_frames_path"] = str(root / f"cache_{tag}")
        conf["paths"]["all_dataset_path"] = str(root / "k360")
        conf["frames_creation"]["nscans_transformation_range"] = RNG
        path = root / f"{tag}.yaml"
        path.write_text(yaml.safe_dump(conf))
        confs.append(str(path))
    return confs


def _run_both(confs, dataset, *actions, extra=()):
    """Each action through the port's CLI (on the CPU) and the JAX
    package's, in order."""
    for action in actions:
        args = ["--dataset", dataset, "--action", action, *extra]
        assert cli.main(["--config", confs[0], *args, "--device",
                         "cpu"]) == 0
        assert jcli.main(["--config", confs[1], *args]) == 0


def _assert_same_files(root, sub):
    """Every cache file under cache_t/<sub> equals cache_j/<sub>'s, array
    for array (dtypes too).  Returns the number of files."""
    names = sorted(os.listdir(root / "cache_t" / sub))
    assert names == sorted(os.listdir(root / "cache_j" / sub)) and names
    for name in names:
        a, b = (np.load(root / f"cache_{tag}" / sub / name)
                for tag in ("t", "j"))
        if name.endswith(".npy"):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
            continue
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key])
    return len(names)


def _assert_same_labels(root, fids):
    """The two packages' label files: names equal, x, y, z, theta and
    h, w, l within 1e-4.  Returns the number of cars."""
    n_cars = 0
    for fid in fids:
        a = read_label_file(str(root / "labels_t" / f"{fid}.txt"))
        b = read_label_file(str(root / "labels_j" / f"{fid}.txt"))
        assert a.names == b.names
        n_cars += len(a.names)
        if len(a.names):
            for got, want in ((a.pos, b.pos), (a.ry, b.ry),
                              (a.hwl, b.hwl)):
                np.testing.assert_allclose(got, want, atol=1e-4)
    return n_cars


@pytest.mark.parametrize("action", ["transformations", "homographies",
                                    "candidates", "frames_aggregation",
                                    "dimensions_output", "demo"])
def test_other_actions_raise(tmp_path, action):
    """Named for what these actions did before they were ported: now only
    ``homographies`` raises.  ``transformations``, ``candidates`` and
    ``frames_aggregation`` write the JAX driver's cache files for
    ``--dataset kitti``, ``kitti360`` (a pose gap in the window) and
    ``waymo_converted`` (``all``: its transformations equal kitti360's);
    ``dimensions_output`` (through the stream of label_frames) and
    ``demo`` (from the merged-cars cache) label one frame with the scale
    detector and the box reducer as the JAX driver does."""
    if action == "homographies":
        with pytest.raises(NotImplementedError, match=r"sowa/stitching"):
            cli.main(["--config", _config(tmp_path, "other"), "--action",
                      action, "--device", "cpu"])
        return
    if action in ("dimensions_output", "demo"):
        confs = _layout(tmp_path, "kitti")
        before = ("frames_aggregation",) if action == "demo" else ()
        _run_both(confs, "kitti", *before)
        _run_both(confs, "kitti", action, extra=("--seq_end", "1"))
        assert sorted(os.listdir(tmp_path / "labels_t")) == ["000010.txt"]
        assert _assert_same_labels(tmp_path, ["000010"]) == 1
        lab = read_label_file(str(tmp_path / "labels_t" / "000010.txt"))
        # the box reducer's length (the scale detector's grid gives 0.75 -
        # 1.25 of the template's 3.88 m): not the template's
        assert lab.hwl[0][2] != pytest.approx(3.88, abs=0.005)
        return
    chain = {"transformations": ("transformations",),
             "candidates": ("transformations", "candidates"),
             "frames_aggregation": ("transformations", "frames_aggregation")}
    sub = {"transformations": "transformations", "candidates": "candidates",
           "frames_aggregation": "merged_cars"}[action]
    for dataset in ("kitti", "kitti360", "waymo_converted"):
        root = tmp_path / dataset
        confs = _layout(root, dataset)
        _run_both(confs, dataset, *chain[action])
        assert _assert_same_files(root, sub) == len(NUMBERS)
        full = np.load(root / "cache_t" / "transformations"
                       / f"{_fids(dataset)[1]}.npy")
        if dataset == "kitti":
            np.testing.assert_array_equal(full, np.tile(np.eye(4),
                                                        (2 * RNG + 1, 1, 1)))
        else:
            # frame 11's window: inv(pose 11) @ pose k, zero at the
            # kitti360 gap; waymo_converted conjugated into the camera
            for k in range(-RNG, RNG + 1):
                want = np.linalg.inv(_pose(11)) @ _pose(11 + k)
                if dataset == "kitti360" and 11 + k == POSE_GAP:
                    want = np.zeros((4, 4))
                elif dataset == "waymo_converted":
                    v2c = np.eye(4)
                    v2c[:3] = np.array(
                        [0, -1, 0, 0.1, 0, 0, -1, 0.2, 1, 0, 0, -0.3]
                    ).reshape(3, 4)
                    want = v2c @ want @ np.linalg.inv(v2c)
                np.testing.assert_allclose(full[k + RNG], want, atol=1e-6)
    if action == "transformations":
        # --dataset all takes the KITTI-360 poses
        root = tmp_path / "all"
        confs = _layout(root, "all")
        _run_both(confs, "all", "transformations")
        assert _assert_same_files(root, "transformations") == len(NUMBERS)
        for fid in _fids("all"):
            np.testing.assert_array_equal(
                np.load(root / "cache_t" / "transformations" / f"{fid}.npy"),
                np.load(tmp_path / "kitti360" / "cache_t"
                        / "transformations" / f"{fid}.npy"))


def test_mask_tracking_without_backend_raises(kitti_dir):
    """No ``backends.mask``: both drivers raise the same error."""
    conf = _config(kitti_dir, "no_mask")
    with pytest.raises(NotImplementedError) as got:
        cli.main(["--config", conf, "--action", "mask_tracking",
                  "--device", "cpu"])
    with pytest.raises(NotImplementedError) as want:
        jcli.main(["--config", conf, "--action", "mask_tracking"])
    assert str(got.value) == str(want.value)
    assert "backends.mask" in str(got.value)


def test_use_sam_raises_naming_sam(kitti_dir, tmp_path):
    """Named for what it checked before SAM was ported: now
    ``frames_creation.use_SAM`` with a live mask backend refines the car
    masks through the SAM checkpoint of ``backends.sam_checkpoint`` (the
    port's) and writes the JAX driver's masks_raw/ files; without a SAM
    checkpoint both drivers raise the same ValueError before any
    frame."""
    from monosowa_tpu_torch.convert import zoo_params
    from monosowa_tpu_torch.models.mask2former import Mask2Former
    from monosowa_tpu_torch.sowa import zoo
    from test_torch_sam import configs, random_tree
    from test_torch_swin_mask2former import CFG

    mtree = zoo_params(Mask2Former(CFG, device="cpu"))
    # every query a car far above refine_masks' 0.7
    mtree["transformer"]["class_predictor"]["bias"][2] += 20.0
    mask_ckpt, sam_ckpt = str(tmp_path / "mask.npz"), str(tmp_path / "sam.npz")
    zoo.save_checkpoint(mask_ckpt, "mask2former", mtree, CFG)
    _, scfg = configs()
    zoo.save_checkpoint(sam_ckpt, "sam", random_tree(scfg), scfg)
    conf = yaml.safe_load(open(_config(kitti_dir, "sam")))
    conf["backends"] = {"mask": "mask2former", "mask_checkpoint": mask_ckpt,
                        "mask_input_hw": [64, 96]}
    conf["frames_creation"]["use_SAM"] = True
    errors = []
    for tag, main, dev in (("torch", cli.main, ["--device", "cpu"]),
                           ("jax", jcli.main, [])):
        conf["paths"]["merged_frames_path"] = str(tmp_path / tag)
        path = tmp_path / f"{tag}_no_sam.yaml"
        path.write_text(yaml.safe_dump(conf))
        with pytest.raises(ValueError, match="sam_path") as got:
            main(["--config", str(path), "--action", "mask_tracking"] + dev)
        errors.append(str(got.value))
        assert not (tmp_path / tag / "masks_raw").exists()
        conf["backends"]["sam_checkpoint"] = sam_ckpt
        path = tmp_path / f"{tag}.yaml"
        path.write_text(yaml.safe_dump(conf))
        assert main(["--config", str(path), "--action", "mask_tracking"]
                    + dev) == 0
        del conf["backends"]["sam_checkpoint"]
    assert errors[0] == errors[1]
    n = 0
    for fid in FIDS:
        got = masks.load_masks(str(tmp_path / "torch" / "masks_raw"), fid)
        want = jmasks.load_masks(str(tmp_path / "jax" / "masks_raw"), fid)
        assert len(got) == len(want)
        n += len(got)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert n > 0


def test_lidar_scans_cached_matches_jax(kitti_dir, tmp_path):
    """`--action lidar_scans` in the cached mode: depth_maps/<fid>.npz ->
    lidar_raw/<fid>.npz, the JAX driver's file; skip-if-exists."""
    for tag in ("t", "j"):
        for i, fid in enumerate(FIDS):
            dm = tmp_path / tag / "depth_maps"
            dm.mkdir(parents=True, exist_ok=True)
            np.savez_compressed(dm / f"{fid}.npz", depth=_random_depth(i))
    confs = {}
    for tag in ("t", "j"):
        conf = yaml.safe_load(open(_config(kitti_dir, f"lidar_{tag}")))
        conf["paths"]["merged_frames_path"] = str(tmp_path / tag)
        confs[tag] = tmp_path / f"{tag}.yaml"
        confs[tag].write_text(yaml.safe_dump(conf))
    assert cli.main(["--config", str(confs["t"]), "--action", "lidar_scans",
                     "--device", "cpu"]) == 0
    assert jcli.main(["--config", str(confs["j"]), "--action",
                      "lidar_scans"]) == 0
    for fid in FIDS:
        got = depth.load_pseudo_lidar(str(tmp_path / "t" / "lidar_raw"
                                          / f"{fid}.npz"))
        want = jdepth.load_pseudo_lidar(str(tmp_path / "j" / "lidar_raw"
                                            / f"{fid}.npz"))
        assert len(got) > 0
        np.testing.assert_array_equal(got, want)
    drv = cli.KittiObjectDriver(cli.load_config(str(confs["t"])),
                                cli.PipelineFlags("lidar_scans"),
                                device="cpu")
    assert drv.run(None, None) == 0


@pytest.mark.parametrize("dataset", ["waymo", "kitti360"])
def test_other_datasets_raise(tmp_path, dataset):
    """Named for what these datasets did before they were ported: both
    run now.  ``--dataset waymo`` goes to the raw Waymo driver
    (``tests/test_torch_waymo.py`` holds its actions against the JAX
    driver's): here an empty ``paths.waymo_path`` labels nothing in either
    package, and a segment without its cameras raises the same error in
    both.  ``--dataset kitti360`` runs transformations, candidates,
    frames_aggregation and optimization (from the merged-cars cache) in the
    seed-360 frame order, with the JAX driver's cache and label files."""
    if dataset == "waymo":
        segs = tmp_path / "segments"
        segs.mkdir()
        conf = tmp_path / "waymo.yaml"
        conf.write_text(yaml.safe_dump({"paths": {
            "waymo_path": str(segs),
            "merged_frames_path": str(tmp_path / "cache") + "/",
            "labels_path": str(tmp_path / "labels") + "/"}}))
        for main, dev in ((cli.main, ["--device", "cpu"]), (jcli.main, [])):
            assert main(["--config", str(conf), "--action", "optimization",
                         "--dataset", dataset] + dev) == 0
        assert not (tmp_path / "labels").exists()
        (segs / "seg-000").mkdir()
        errors = []
        for main, dev in ((cli.main, ["--device", "cpu"]), (jcli.main, [])):
            with pytest.raises(FileNotFoundError) as err:
                main(["--config", str(conf), "--action", "optimization",
                      "--dataset", dataset] + dev)
            errors.append(str(err.value))
        assert errors[0] == errors[1]
        return
    confs = _layout(tmp_path, dataset)
    _run_both(confs, dataset, "transformations", "candidates",
              "frames_aggregation", "optimization")
    for sub in ("transformations", "candidates", "merged_cars"):
        assert _assert_same_files(tmp_path, sub) == len(NUMBERS)
    assert _assert_same_labels(tmp_path, _fids(dataset)) == len(NUMBERS)


def test_shuffled_frame_order_matches_jax():
    for n, lo, hi in ((10, None, None), (37, 5, 20), (1000, 990, None)):
        want = jcli.shuffled_frame_order(n, lo, hi)
        np.testing.assert_array_equal(cli.shuffled_frame_order(n, lo, hi),
                                      want)
        np.random.seed(360)
        longhand = np.arange(n)
        np.random.shuffle(longhand)
        np.testing.assert_array_equal(want, longhand[lo:hi])


def test_pose_gap_inside_the_window_raises_in_both(tmp_path):
    """A KITTI-360 pose gap inside the aggregation window: the zero
    matrix reaches aggregation's ``np.linalg.inv`` of the window in both
    packages, which raise the same error (the reference skips such
    frames)."""
    confs = _layout(tmp_path, "kitti360")
    for path in confs:
        conf = yaml.safe_load(open(path))
        conf["frames_creation"]["nscans_before"] = RNG
        conf["frames_creation"]["nscans_after"] = RNG
        open(path, "w").write(yaml.safe_dump(conf))
    _run_both(confs, "kitti360", "transformations")
    args = ["--dataset", "kitti360", "--action", "frames_aggregation"]
    with pytest.raises(np.linalg.LinAlgError) as got:
        cli.main(["--config", confs[0], *args, "--device", "cpu"])
    with pytest.raises(np.linalg.LinAlgError) as want:
        jcli.main(["--config", confs[1], *args])
    assert str(got.value) == str(want.value)
