"""The torch port's copy of the KITTI dataset, training split, against the
JAX package's, and the port's training batch feeding its train step.

A synthetic KITTI tree (tests/test_canonical_module.py:23 builds the same
kind) with three frames of several objects each, some truncated, occluded
or of classes outside the write list.  Both datasets draw their flip and
crop from the global ``np.random``, so each sample is drawn after the same
``np.random.seed``; the samples and their ``collate`` must be identical.
(``aug_pd``, off in the shipped configs, draws from an unseeded
``np.random.default_rng()`` in both packages and is left out.)
"""

import numpy as np
import pytest
from PIL import Image

from monosowa_tpu.data.kitti_dataset import KittiDetectionDataset as JaxDS
from monosowa_tpu.data.kitti_dataset import collate as jax_collate
from monosowa_tpu_torch.data.kitti_dataset import KittiDetectionDataset
from monosowa_tpu_torch.data.kitti_dataset import collate
from test_torch_train import _one_torch_thread  # noqa: F401 (autouse)

IMG_W, IMG_H = 1242, 375
P2 = np.array([[721.5, 0, 609.6, 44.9], [0, 721.5, 172.9, 0.2],
               [0, 0, 1, 0.003]])
LABELS = [
    ["Car 0.00 0 -1.40 500.00 160.00 620.00 220.00 "
     "1.52 1.63 3.88 -1.50 1.70 25.00 -1.46",
     "Car 0.30 1 1.20 0.00 150.00 140.00 260.00 "
     "1.45 1.60 4.10 -9.80 1.65 12.50 0.50",
     "Pedestrian 0.00 0 0.30 700.00 140.00 730.00 230.00 "
     "1.75 0.60 0.80 2.10 1.70 18.00 0.40"],
    ["Van 0.00 0 -0.20 800.00 150.00 950.00 240.00 "
     "2.10 1.90 5.00 6.00 1.80 20.00 0.10",
     "Car 0.00 2 2.80 300.00 170.00 380.00 210.00 "
     "1.50 1.62 3.90 -8.00 1.70 40.00 2.60",
     "DontCare -1 -1 -10 100.00 160.00 200.00 200.00 "
     "-1 -1 -1 -1000 -1000 -1000 -10"],
    ["Car 0.00 0 0.10 560.00 175.00 700.00 240.00 "
     "1.55 1.70 4.20 0.50 1.72 15.00 0.13"],
]
CFGS = {
    "plain": {"random_flip": 0.5},
    "augmented": {"random_flip": 0.5, "aug_crop": True, "random_crop": 0.9,
                  "use_canonical_module": True,
                  "class_merging": True, "max_objs": 8},
}


@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_train")
    for sub in ("image_2", "calib", "label_2"):
        (root / "training" / sub).mkdir(parents=True)
    rng = np.random.default_rng(0)
    p2l = " ".join(str(v) for v in P2.reshape(-1))
    ids = []
    for i, rows in enumerate(LABELS):
        fid = f"{3 + 5 * i:06d}"
        ids.append(fid)
        Image.fromarray(rng.integers(0, 256, (IMG_H, IMG_W, 3), np.uint8)
                        ).save(root / "training" / "image_2" / f"{fid}.png")
        (root / "training" / "calib" / f"{fid}.txt").write_text(
            f"P0: {p2l}\nP1: {p2l}\nP2: {p2l}\nP3: {p2l}\n"
            "R0_rect: 1 0 0 0 1 0 0 0 1\n"
            "Tr_velo_to_cam: 1 0 0 0 0 1 0 0 0 0 1 0\n")
        (root / "training" / "label_2" / f"{fid}.txt").write_text(
            "\n".join(rows) + "\n")
    (root / "ImageSets").mkdir()
    (root / "ImageSets" / "train.txt").write_text("\n".join(ids) + "\n")
    return str(root)


def _both(kitti_dir, cfg, seeds):
    jds = JaxDS(kitti_dir, "train", dict(cfg))
    tds = KittiDetectionDataset(kitti_dir, "train", dict(cfg))
    assert len(jds) == len(tds) == len(LABELS)
    out = []
    for item, seed in enumerate(seeds):
        np.random.seed(seed)
        j = jds[item]
        np.random.seed(seed)
        out.append((tds[item], j))
    return out


@pytest.mark.parametrize("name", sorted(CFGS))
def test_train_samples_match_jax(kitti_dir, name):
    flips = []
    for t, j in _both(kitti_dir, CFGS[name], seeds=(0, 1, 2)):
        assert sorted(t) == sorted(j)
        for k in j:
            assert np.asarray(t[k]).dtype == np.asarray(j[k]).dtype, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        assert t["valid"].any()
        flips.append(bool(t["flip_flag"]))
    assert len(set(flips)) == 2        # these seeds flip some, not all


def test_collate_matches_jax(kitti_dir):
    pairs = _both(kitti_dir, CFGS["augmented"], seeds=(3, 4, 5))
    got = collate([t for t, _ in pairs])
    want = jax_collate([j for _, j in pairs])
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == \
            want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["image"].shape == (3, 384, 1280, 3)


def test_collated_batch_feeds_the_train_step(kitti_dir):
    """A collated training batch of the real dataset through the port's
    make_train_step (a tiny model on the CPU): finite losses, some valid
    targets matched."""
    import torch

    from monosowa_tpu_torch.models.monodetr import MonoDETR
    from monosowa_tpu_torch.train.optim import make_optimizer
    from monosowa_tpu_torch.train.trainer import make_train_step

    np.random.seed(0)
    ds = KittiDetectionDataset(kitti_dir, "train", dict(CFGS["augmented"]))
    batch = collate([ds[i] for i in range(2)])
    # a smaller input for the CPU: every 4th pixel of the network input
    batch["image"] = np.ascontiguousarray(batch["image"][:, ::4, ::4])
    model = MonoDETR(device="cpu", enc_layers=1, dec_layers=1, group_num=2,
                     d_model=64, d_ffn=64, nheads=4, num_queries=10,
                     num_depth_bins=16)
    losses = make_train_step(model, None, make_optimizer(model))(
        batch, torch.Generator().manual_seed(0))
    assert all(np.isfinite(v) for v in losses.values())
    assert losses["loss_center"] > 0 and losses["grad_norm"] > 0


def test_use_add_data_names_what_the_port_lacks(kitti_dir, tmp_path):
    """use_add_data is ported (the port lacks nothing of it any more): the
    dataset builds, and frames without a cached car carry the JAX
    dataset's empty payload, key for key (tests/test_torch_add_data.py
    holds frames with cars)."""
    cfg = {"use_add_data": True, "add_data_path": str(tmp_path),
           "add_data_points": 64, "max_add_cars": 3, "add_mask_stride": 8}
    for t, j in _both(kitti_dir, cfg, seeds=(0, 1, 2)):
        assert sorted(t) == sorted(j)
        assert {"car_points", "car_masks", "car_valid"} <= set(t)
        for k in j:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        assert t["car_masks"].shape == (3, 48, 160)
        assert not t["car_valid"].any()
