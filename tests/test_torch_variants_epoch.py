"""The detector's variants through the torch port's command line
(``tools/train_val_torch.py`` ``main``): a yaml of the shipped
configs/monodetr_kitti.yaml model keys with the flags turned on, at the
widths of tests/test_torch_train_val.py, over its synthetic KITTI directory
of PNGs.  ``use_depth`` reads a dense depth map per frame (``depth_path``,
one .npy each) through the dataset's own warp into the 4th input channel,
which ``collate``, the loader, ``make_train_step`` and ``run_inference``
carry unchanged.  One epoch of one step with the JV matcher, a checkpoint,
the test pass and its AP.
"""

import os

import numpy as np
import pytest
import yaml

from monosowa_tpu_torch.config import load_yaml
from monosowa_tpu_torch.data.kitti_dataset import (KittiDetectionDataset,
                                                   collate)
from test_torch_train import _one_torch_thread  # noqa: F401 (autouse)
from test_torch_train_val import (IMG_H, IMG_W, MODEL_CFG, _dataset_cfg,
                                  kitti_root)  # noqa: F401 (fixture)
from tools import train_val_torch as cli

SHIPPED = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "monodetr_kitti.yaml")
VARIANTS = {"two_stage": {"two_stage": True},
            "dab_learned_depth": {"use_dab": True,
                                  "position_embedding": "learned",
                                  "use_depth": True}}


@pytest.fixture(scope="module")
def depth_dir(kitti_root, tmp_path_factory):
    """A dense depth map (metres) per frame of ``kitti_root``, .npy."""
    out = tmp_path_factory.mktemp("depth")
    rng = np.random.default_rng(2)
    for i in range(4):
        np.save(out / f"{i:06d}.npy",
                rng.uniform(2.0, 80.0, (IMG_H, IMG_W)).astype(np.float32))
    return out


def _cfg(kitti_root, depth_dir, tmp, flags):
    model = {**load_yaml(SHIPPED)["model"], **MODEL_CFG, **flags}
    dataset = _dataset_cfg(kitti_root)
    if flags.get("use_depth"):
        dataset.update(use_depth=True, depth_path=str(depth_dir))
    return {"random_seed": 444, "dataset": dataset, "model": model,
            "optimizer": {"type": "adamw", "lr": 2e-4, "weight_decay": 1e-4},
            "lr_scheduler": {"type": "step", "decay_list": [125, 165]},
            "trainer": {"max_epoch": 1, "save_frequency": 1,
                        "save_path": str(tmp / "out")},
            "tester": {"threshold": 0.0, "topk": 10}}


def test_depth_channel_reaches_the_batch(kitti_root, depth_dir):
    """The dataset's 4th channel is the warped depth, clipped to 150 m and
    mapped to [-1, 1] (reference kitti_dataset.py:224-230); ``collate``
    stacks it with the image."""
    ds = KittiDetectionDataset(str(kitti_root), "train", _dataset_cfg(
        kitti_root, use_depth=True, depth_path=str(depth_dir)))
    batch = collate([ds[0], ds[1]])
    assert batch["image"].shape == (2, IMG_H, IMG_W, 4)
    d = batch["image"][..., 3]
    assert d.min() >= -1.0 and d.max() <= 1.0 and d.std() > 0.1


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_epoch_trains_and_tests(name, kitti_root, depth_dir,
                                        tmp_path):
    cfg = _cfg(kitti_root, depth_dir, tmp_path, VARIANTS[name])
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    record = cli.main(["--config", str(path), "--device", "cpu"])
    assert record["device"] == "cpu"
    (epoch,) = record["epochs"]
    assert len(epoch["loss_total"]) == 1
    assert np.isfinite(epoch["loss_total"]).all()
    losses = epoch["losses"]
    assert losses["grad_norm"] > 0
    assert ("loss_giou_enc" in losses) == (name == "two_stage")
    out = tmp_path / "out"
    assert os.path.exists(out / "checkpoint_epoch_1")
    files = sorted(os.listdir(out / "outputs" / "data"))
    assert files == ["000002.txt", "000003.txt"]
    for f in files:
        rows = (out / "outputs" / "data" / f).read_text().splitlines()
        assert len(rows) == 10
    (evaluated,) = record["evaluated"]
    assert evaluated["ap"] > 0 and len(evaluated["results"]) == 6
