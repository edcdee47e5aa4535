"""The port's model zoo (``sowa/zoo.py``) against the JAX package's, on the
CPU: checkpoints written by one load in the other, the backends a config
selects, and the CLI's live ``lidar_scans`` and ``mask_tracking`` over a
tiny KITTI tree, whose cache files must equal the JAX driver's.

Tolerances: a JAX-written checkpoint gives the port the JAX network's
outputs within the bars of ``tests/test_torch_depth_anything.py`` and
``tests/test_torch_swin_mask2former.py`` (2e-5 of ``max_depth``, 1e-5 of
the logits' magnitude).  The ``masks_raw/`` and ``pedestrians/`` files
are equal; the ``lidar_raw/`` points within 1e-3 of ``max_depth`` (the
depth backend's image encode is OpenCV's INTER_CUBIC within one uint8
step)."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from monosowa_tpu.models import depth_anything as jda
from monosowa_tpu.models import mask2former as jm2f
from monosowa_tpu.sowa import cli as jcli
from monosowa_tpu.sowa import masks as jmasks
from monosowa_tpu.sowa import zoo as jzoo
from monosowa_tpu_torch.config import Config
from monosowa_tpu_torch.convert import load_zoo_params, zoo_params
from monosowa_tpu_torch.models import depth_anything as da
from monosowa_tpu_torch.models import mask2former as m2f
from monosowa_tpu_torch.sowa import cli, depth, masks, zoo

from test_torch_depth_anything import configs, unit_gain
from test_torch_swin_mask2former import CFG, car_bias

pytest.importorskip("cv2")
torch.set_num_threads(1)    # the suite runs six worker processes at once

H, W = 96, 160
P2 = np.array([[140.0, 0, W / 2, 0], [0, 140.0, H / 2, 0], [0, 0, 1, 0]])
MASK_HW = (64, 96)
MASK_THRESHOLD = 0.3


def test_flatten_matches_jax():
    tree = {"a": [{"k": np.ones(2)}, {"k": np.zeros(3)}],
            "b": {"c": np.arange(4.0)}}
    got, want = zoo.flatten_params(tree), jzoo.flatten_params(tree)
    assert got.keys() == want.keys()
    back = zoo.unflatten_params(got)
    assert isinstance(back["a"], list) and len(back["a"]) == 2
    np.testing.assert_array_equal(back["b"]["c"], tree["b"]["c"])
    with pytest.raises(ValueError):
        zoo.flatten_params({"a/b": np.ones(1)})


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """A depth checkpoint written by the JAX package and a mask checkpoint
    written by the port (its seeded weights, the biases of the car label
    and of label 0, the person label, raised so that some queries pass
    MASK_THRESHOLD for each on the tree's first frame)."""
    root = tmp_path_factory.mktemp("zoo")
    jcfg, _ = configs("gelu")
    dtree = unit_gain(jda.init_depth_anything_params(0, jcfg))
    dpath = str(root / "depth.npz")
    jzoo.save_checkpoint(dpath, "depth_anything", dtree, jcfg)
    mtree = zoo_params(m2f.Mask2Former(CFG, device="cpu", seed=0))
    img = frame_image(0)
    bias = mtree["transformer"]["class_predictor"]["bias"]
    bias[2] += car_bias(mtree, CFG, img, MASK_HW, quantile=0.5, target=0.5)
    bias[0] += car_bias(mtree, CFG, img, MASK_HW, label=0, quantile=0.3,
                        target=0.4)
    mpath = str(root / "mask.npz")
    zoo.save_checkpoint(mpath, "mask2former", mtree, CFG)
    return {"depth": dpath, "depth_tree": dtree, "mask": mpath,
            "mask_tree": mtree}


def test_jax_checkpoint_loads_into_the_port(ckpts):
    kind, tree, cfg = zoo.load_checkpoint(ckpts["depth"])
    jkind, jtree, jcfg = jzoo.load_checkpoint(ckpts["depth"])
    assert kind == jkind == "depth_anything"
    assert isinstance(cfg, da.DepthAnythingConfig)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    model = load_zoo_params(da.DepthAnything(cfg, device="cpu"), tree)
    x = np.random.default_rng(0).normal(size=(1, 56, 84, 3)).astype(
        np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = np.asarray(jda.depth_anything_forward(jtree, jnp.asarray(x),
                                                 jcfg))
    err = float(np.abs(got - want).max())
    print(json.dumps({"jax_checkpoint_depth_err": err}))
    assert err <= 2e-5 * cfg.max_depth


def test_port_checkpoint_loads_into_jax(ckpts):
    kind, tree, cfg = jzoo.load_checkpoint(ckpts["mask"])
    assert kind == "mask2former"
    assert dataclasses.asdict(cfg) == dataclasses.asdict(CFG)
    flat, want = jzoo.flatten_params(tree), zoo.flatten_params(
        ckpts["mask_tree"])
    assert flat.keys() == want.keys()
    for k in flat:
        np.testing.assert_array_equal(flat[k], want[k])
    x = np.random.default_rng(1).normal(size=(1, 64, 96, 3)).astype(
        np.float32)
    model = load_zoo_params(m2f.Mask2Former(CFG, device="cpu", seed=5),
                            zoo.load_checkpoint(ckpts["mask"])[1])
    with torch.no_grad():
        cls, msk = model(torch.from_numpy(x))
    jcls, jmsk = jm2f.mask2former_forward(tree, jnp.asarray(x), cfg)
    for g, w in ((cls, jcls), (msk, jmsk)):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


def test_kinds_not_ported_raise(tmp_path):
    """Named for what it checked before the Waymo networks were ported:
    ``loftr`` and ``vit_tracker`` raised naming their JAX module.  Now
    they, like ``sam``, write and read back with their config dataclasses
    (``tests/test_torch_waymo.py`` and ``test_torch_sam.py`` hold the
    networks against the JAX package); an unknown kind raises."""
    from monosowa_tpu_torch.models.efficientloftr import EfficientLoFTRConfig
    from monosowa_tpu_torch.models.sam import SamConfig
    from monosowa_tpu_torch.models.vit_tracker import ViTTrackerConfig

    for kind, cfg in (("loftr", EfficientLoFTRConfig()),
                      ("vit_tracker", ViTTrackerConfig()),
                      ("sam", SamConfig())):
        path = str(tmp_path / f"{kind}.npz")
        zoo.save_checkpoint(path, kind, {"t": np.ones(2, np.float32)}, cfg)
        got_kind, tree, got = zoo.load_checkpoint(path)
        assert (got_kind, got) == (kind, cfg)
        np.testing.assert_array_equal(tree["t"], np.ones(2))
    with pytest.raises(ValueError, match="unknown"):
        zoo.save_checkpoint(str(tmp_path / "x.npz"), "resnet", {}, None)


def test_backends_from_config(ckpts, tmp_path):
    cfg = Config({})
    assert zoo.mask_backend(cfg) is None
    assert zoo.sam_refine_backend(cfg) is None
    assert isinstance(zoo.depth_backend(cfg, str(tmp_path)),
                      depth.CachedDepthBackend)
    with pytest.raises(NotImplementedError, match="metric3d|Metric3D"):
        zoo.depth_backend(Config({"backends": {"depth": "metric3d_hub"}}),
                          str(tmp_path))
    with pytest.raises(ValueError):
        zoo.depth_backend(Config({"backends": {"depth": "lidar"}}), "")
    with pytest.raises(ValueError):
        zoo.mask_backend(Config({"backends": {"mask": "detectron"}}))
    with pytest.raises(ValueError, match="expected 'mask2former'"):
        zoo.mask_backend(Config({"backends": {
            "mask": "mask2former", "mask_checkpoint": ckpts["depth"]}}),
            device="cpu")
    with pytest.raises(ValueError, match="sam_path"):
        zoo.sam_refine_backend(Config({"frames_creation": {"use_SAM": True}}))
    b = zoo.mask_backend(Config({
        "backends": {"mask": "mask2former", "mask_checkpoint": ckpts["mask"],
                     "mask_input_hw": [70, 100], "mask_car_labels": [2, 3]},
        "filtering": {"score_detectron_thresh": 0.5}}), device="cpu")
    assert isinstance(b, masks.Mask2FormerBackend)
    assert b.input_hw == (64, 96) and b.car_label_ids == (2, 3)
    assert b.score_threshold == 0.5
    d = zoo.depth_backend(Config({"backends": {
        "depth": "depth_anything", "depth_checkpoint": ckpts["depth"],
        "depth_input_size": 28}}), str(tmp_path), device="cpu")
    assert isinstance(d, depth.DepthAnythingBackend)
    assert d.input_size == 28 and d.fx == depth.CANONICAL_FOCAL


# ---------------------------------------------------------------------------
# the CLI's live actions, port and JAX driver over one KITTI tree
# ---------------------------------------------------------------------------

FIDS = ["000000", "000001"]


def frame_image(i):
    """A frame with structure (smooth gradients and noise), uint8."""
    rng = np.random.default_rng(100 + i)
    yy, xx = np.mgrid[0:H, 0:W]
    base = np.stack([xx * 255 / W, yy * 255 / H,
                     127 + 100 * np.sin(xx / 9.0 + i)], -1)
    return np.clip(base + rng.normal(0, 20, (H, W, 3)), 0, 255).astype(
        np.uint8)


@pytest.fixture(scope="module")
def kitti(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_zoo")
    kd = root / "kitti"
    (kd / "training" / "image_2").mkdir(parents=True)
    (kd / "training" / "calib").mkdir(parents=True)
    p2_line = " ".join(str(v) for v in P2.reshape(-1))
    calib = "\n".join([f"P{i}: {p2_line}" for i in range(4)]
                      + ["R0_rect: 1 0 0 0 1 0 0 0 1",
                         "Tr_velo_to_cam: 1 0 0 0 0 1 0 0 0 0 1 0",
                         "Tr_imu_to_velo: 1 0 0 0 0 1 0 0 0 0 1 0"]) + "\n"
    for i, fid in enumerate(FIDS):
        Image.fromarray(frame_image(i)).save(
            kd / "training" / "image_2" / f"{fid}.png")
        (kd / "training" / "calib" / f"{fid}.txt").write_text(calib)
    return root


def _config(root, tag, extra):
    cfg = {"paths": {"kitti_path": str(root / "kitti"),
                     "merged_frames_path": str(root / tag),
                     "labels_path": str(root / tag / "labels")}}
    for k, v in extra.items():
        cfg.setdefault(k, {}).update(v)
    path = root / f"{tag}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_mask_tracking_matches_jax_driver(kitti, ckpts):
    """`--action mask_tracking` with backends.mask: mask2former, cars and
    (extract_pedestrians) persons from one forward: masks_raw/ and
    pedestrians/ files equal to the JAX driver's."""
    extra = {"backends": {"mask": "mask2former",
                          "mask_checkpoint": ckpts["mask"],
                          "mask_input_hw": list(MASK_HW)},
             "filtering": {"score_detectron_thresh": MASK_THRESHOLD},
             "frames_creation": {"extract_pedestrians": True}}
    for tag, main, dev in (("torch_m", cli.main, ["--device", "cpu"]),
                           ("jax_m", jcli.main, [])):
        assert main(["--config", _config(kitti, tag, extra), "--action",
                     "mask_tracking"] + dev) == 0
    counts = {}
    for sub in ("masks_raw", "pedestrians"):
        for fid in FIDS:
            got = masks.load_masks(str(kitti / "torch_m" / sub), fid)
            want = jmasks.load_masks(str(kitti / "jax_m" / sub), fid)
            assert len(got) == len(want)
            counts[f"{sub}/{fid}"] = len(got)
            for a, b in zip(got, want):
                assert a.shape == (H, W)
                np.testing.assert_array_equal(a, b)
    print(json.dumps({"masks_written": counts}))
    assert counts["masks_raw/000000"] > 0
    assert counts["pedestrians/000000"] > 0
    # skip-if-exists: a second run writes nothing
    assert cli.KittiObjectDriver(
        cli.load_config(_config(kitti, "torch_m", extra)),
        cli.PipelineFlags("mask_tracking"), device="cpu").run(None,
                                                              None) == 0


def test_lidar_scans_matches_jax_driver(kitti, ckpts):
    """`--action lidar_scans` with backends.depth: depth_anything: the
    frame's image through the network, its calib's fx, lidar_raw/ points
    as the JAX driver's."""
    extra = {"backends": {"depth": "depth_anything",
                          "depth_checkpoint": ckpts["depth"],
                          "depth_input_size": 42}}
    for tag, main, dev in (("torch_d", cli.main, ["--device", "cpu"]),
                           ("jax_d", jcli.main, [])):
        assert main(["--config", _config(kitti, tag, extra), "--action",
                     "lidar_scans"] + dev) == 0
    for fid in FIDS:
        got = depth.load_pseudo_lidar(str(kitti / "torch_d" / "lidar_raw"
                                          / f"{fid}.npz"))
        want = depth.load_pseudo_lidar(str(kitti / "jax_d" / "lidar_raw"
                                           / f"{fid}.npz"))
        assert got.shape == want.shape and len(got) > 0.9 * H * W
        err = float(np.abs(got - want).max())
        print(json.dumps({f"lidar_raw/{fid}": err}))
        assert err <= 1e-3 * 80.0 * 1.5
