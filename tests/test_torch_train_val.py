"""The port's train -> checkpoint -> test -> KITTI AP loop against the JAX
package's: the epoch loader's order, ``tester.test`` (result files and the
AP dict) with the weights carried over, and ``tools/train_val_torch.py``
end to end on the CPU.

Sizes: the synthetic KITTI directory and the model widths of
tests/test_train_val_cli.py (96x160 images, d_model 64, 1 + 2 layers, 4
heads, 10 queries, 16 depth bins).  Tolerances: result files agree to their
printed two decimals (0.01) with ``tester.threshold`` 0, so that the files
hold rows (random-init scores are about 0.01); AP dicts within 1e-6
(tests/test_eval_reference_parity.py:155).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from monosowa_tpu.data.kitti_dataset import \
    KittiDetectionDataset as JaxDataset                         # noqa: E402
from monosowa_tpu.models.monodetr import MonoDETR as JaxMonoDETR  # noqa: E402
from monosowa_tpu.train import tester as jax_tester             # noqa: E402
from monosowa_tpu.train.trainer import TrainState               # noqa: E402
from monosowa_tpu_torch.convert import load_flax_params         # noqa: E402
from monosowa_tpu_torch.data.kitti_dataset import (             # noqa: E402
    KittiDetectionDataset, collate)
from monosowa_tpu_torch.data.loader import build_loader         # noqa: E402
from monosowa_tpu_torch.models.monodetr import MonoDETR         # noqa: E402
from monosowa_tpu_torch.train import checkpoint as ckpt_io      # noqa: E402
from monosowa_tpu_torch.train import tester                     # noqa: E402
from monosowa_tpu_torch.train.sample import (SampleDataset,     # noqa: E402
                                             write_sample_labels)
from test_torch_slice import _spread_offsets                    # noqa: E402
from test_torch_train import _one_torch_thread  # noqa: E402,F401 (fixture)
from tools import train_val as jax_cli                          # noqa: E402
from tools import train_val_torch as cli                        # noqa: E402

IMG_W, IMG_H = 160, 96
P2 = np.array([[120.0, 0, IMG_W / 2, 0], [0, 120.0, IMG_H / 2, 0],
               [0, 0, 1, 0]])
TINY = dict(enc_layers=1, dec_layers=2, group_num=1, d_model=64, d_ffn=64,
            nheads=4, num_queries=10, num_depth_bins=16)
MODEL_CFG = {"num_classes": 3, "enc_layers": 1, "dec_layers": 2,
             "hidden_dim": 64, "dim_feedforward": 64, "nheads": 4,
             "num_queries": 10, "num_depth_bins": 16,
             "cls_loss_coef": 2, "bbox_loss_coef": 5}


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    """The synthetic KITTI directory of tests/test_train_val_cli.py: four
    noise PNGs with one car each, two for training and two for testing."""
    root = tmp_path_factory.mktemp("kitti_torch_cli")
    for sub in ("image_2", "calib", "label_2"):
        (root / "training" / sub).mkdir(parents=True)
    rng = np.random.default_rng(0)
    ids = [f"{i:06d}" for i in range(4)]
    p2l = " ".join(str(v) for v in P2.reshape(-1))
    for fid in ids:
        Image.fromarray(rng.integers(0, 255, (IMG_H, IMG_W, 3),
                                     dtype=np.uint8)).save(
            root / "training" / "image_2" / f"{fid}.png")
        (root / "training" / "calib" / f"{fid}.txt").write_text(
            f"P0: {p2l}\nP1: {p2l}\nP2: {p2l}\nP3: {p2l}\n"
            "R0_rect: 1 0 0 0 1 0 0 0 1\n"
            "Tr_velo_to_cam: 1 0 0 0 0 1 0 0 0 0 1 0\n")
        (root / "training" / "label_2" / f"{fid}.txt").write_text(
            "Car 0.00 0 -1.40 60.00 40.00 100.00 70.00 "
            "1.52 1.63 3.88 -1.50 1.70 10.00 -1.46\n")
    (root / "ImageSets").mkdir()
    (root / "ImageSets" / "train.txt").write_text("\n".join(ids[:2]) + "\n")
    (root / "ImageSets" / "val.txt").write_text("\n".join(ids[2:]) + "\n")
    return root


def _dataset_cfg(root, **extra):
    return {"type": "KITTI", "root_dir": str(root), "train_split": "train",
            "test_split": "val", "batch_size": 2,
            "resolution": [IMG_W, IMG_H], "max_objs": 8, "random_flip": 0.0,
            "aug_crop": False, "use_canonical_module": True,
            "canonical_focal_length": 120.0, **extra}


class _Indices:
    """A dataset whose samples are their own indices."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, j):
        return {"i": np.int64(j)}


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("n,batch", [(11, 4), (8, 2), (3, 4)])
def test_loader_visits_the_jax_tools_indices(shuffle, n, batch):
    """Seed 444, three epochs from one loader: the same batches in the same
    order, the partial last batch dropped."""
    ours = build_loader(_Indices(n), batch, shuffle, seed=444)
    theirs = jax_cli.build_loader(_Indices(n), batch, shuffle, seed=444)
    for _ in range(3):
        got = [b["i"].tolist() for b in ours()]
        want = [b["i"].tolist() for b in theirs()]
        assert got == want
        assert len(got) == n // batch and all(len(b) == batch for b in got)
    if not shuffle and n >= batch:
        assert got[0] == list(range(batch))


def test_loader_hands_a_failing_sample_to_the_consumer():
    class Broken(_Indices):
        def __getitem__(self, j):
            if j == 5:
                raise KeyError("sample 5")
            return super().__getitem__(j)

    with pytest.raises(KeyError, match="sample 5"):
        list(build_loader(Broken(8), 2, False)())
    # an abandoned epoch leaves nothing behind that blocks the next one
    loader = build_loader(_Indices(40), 2, False, prefetch=2)
    first = next(iter(loader()))
    assert first["i"].tolist() == [0, 1]
    assert len(list(loader())) == 20


@pytest.fixture(scope="module")
def both_tests(kitti_root, tmp_path_factory):
    """``tester.test`` of both packages on the val split, same weights."""
    out = tmp_path_factory.mktemp("test_both")
    ds_cfg = _dataset_cfg(kitti_root)
    j_ds = JaxDataset(str(kitti_root), "val", ds_cfg)
    t_ds = KittiDetectionDataset(str(kitti_root), "val", ds_cfg)
    batch = collate([t_ds[0]])
    jm = JaxMonoDETR(msda_backend="xla", compute_dtype="float32", **TINY)
    v = jax.jit(lambda *a: jm.init(jax.random.PRNGKey(0), *a))(
        *[batch[k] for k in ("image", "calib", "img_size")])
    params = _spread_offsets(v["params"], np.random.default_rng(1))
    frozen = jax.tree_util.tree_map(np.asarray, v["frozen"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       frozen=frozen, opt_state=(), tx=None)
    tm = MonoDETR(device="cpu", **TINY)
    load_flax_params(tm, params, frozen)
    cfgs = {name: {"dataset": ds_cfg, "tester": {"threshold": 0.0,
                                                 "topk": 10},
                   "trainer": {"save_path": str(out / name)}}
            for name in ("jax", "torch")}
    quiet = lambda s: None                                   # noqa: E731
    j_res = jax_tester.test(jm, state, j_ds, cfgs["jax"], quiet)
    t_res = tester.test(tm, t_ds, cfgs["torch"], quiet)
    return dict(j_res=j_res, t_res=t_res, j_ds=j_ds, t_ds=t_ds, cfgs=cfgs,
                j_files=str(out / "jax" / "outputs" / "data"),
                t_files=str(out / "torch" / "outputs" / "data"))


def test_result_files_match_jax(both_tests):
    names = sorted(os.listdir(both_tests["j_files"]))
    assert names == sorted(os.listdir(both_tests["t_files"])) == [
        "000002.txt", "000003.txt"]
    worst = 0.0
    for name in names:
        with open(os.path.join(both_tests["j_files"], name)) as f:
            j_rows = [ln.split() for ln in f]
        with open(os.path.join(both_tests["t_files"], name)) as f:
            t_rows = [ln.split() for ln in f]
        assert len(t_rows) == len(j_rows) == 10
        for tr, jr in zip(t_rows, j_rows):
            assert tr[:3] == jr[:3]           # class, truncation, occlusion
            diff = np.abs(np.array(tr[3:], float) - np.array(jr[3:], float))
            worst = max(worst, float(diff.max()))
    print(json.dumps({"test": "result_files", "max_abs_diff_vs_jax": worst}))
    assert worst <= 0.0101


def _same_ap(got, want):
    assert list(got) == list(want) and len(want) == 6
    for key in want:
        np.testing.assert_allclose(got[key]["ap40"], want[key]["ap40"],
                                   rtol=0, atol=1e-6, err_msg=key)
        np.testing.assert_allclose(got[key]["ap11"], want[key]["ap11"],
                                   rtol=0, atol=1e-6, err_msg=key)


def test_ap_dict_matches_jax(both_tests, kitti_root):
    _same_ap(both_tests["t_res"], both_tests["j_res"])
    quiet = lambda s: None                                   # noqa: E731
    # both scorers over the same files: the port's results, then the ground
    # truth itself as detections (a non-zero AP)
    gt_dir = str(kitti_root / "training" / "label_2")
    for results_dir in (both_tests["t_files"], gt_dir):
        got = tester.evaluate_results(both_tests["t_ds"], results_dir,
                                      both_tests["cfgs"]["torch"], quiet)
        want = jax_tester.evaluate_results(both_tests["j_ds"], results_dir,
                                           both_tests["cfgs"]["jax"], quiet)
        _same_ap(got, want)
    # the 30-pixel cars count from Moderate on; two boxes give two of the 41
    # score thresholds, the second of which is one of AP_R40's 40 points
    assert got["car_3d_strict"]["ap40"] == pytest.approx([0.0, 2.5, 2.5])


def test_visualisation_is_refused_not_skipped(both_tests, tmp_path):
    """``visu`` (and ``tester.visu_predictions``) render, as in the JAX
    tester: one BEV PNG an image under outputs/visu, the same names as the
    JAX tester writes, and the same pixels as the JAX package's
    ``visualize_results`` over the same result files and ground truth."""
    quiet = lambda s: None                                   # noqa: E731
    tm = MonoDETR(device="cpu", **TINY)
    cfgs = {name: {**cfg, "trainer": {"save_path": str(tmp_path / name)}}
            for name, cfg in both_tests["cfgs"].items()}
    tester.test(tm, both_tests["t_ds"], cfgs["torch"], quiet, visu=True)
    visu = tmp_path / "torch" / "outputs" / "visu"
    names = sorted(os.listdir(visu))
    assert names == ["000002.png", "000003.png"]
    results = str(tmp_path / "torch" / "outputs" / "data")
    jax_tester.visualize_results(both_tests["j_ds"], results, cfgs["jax"],
                                 quiet)
    jax_visu = tmp_path / "jax" / "outputs" / "visu"
    assert sorted(os.listdir(jax_visu)) == names
    for name in names:
        got = np.asarray(Image.open(visu / name).convert("RGBA"))
        want = np.asarray(Image.open(jax_visu / name).convert("RGBA"))
        np.testing.assert_array_equal(got, want)
    # the tester section's flag, with no ground truth drawn
    cfg = {**cfgs["torch"], "trainer": {"save_path": str(tmp_path / "flag")},
           "tester": {**cfgs["torch"]["tester"], "visu_predictions": True,
                      "visu_ground_truth": False}}
    tester.run_inference(tm, tester.dataset_batches(both_tests["t_ds"], 2),
                         cfg, quiet)
    assert sorted(os.listdir(tmp_path / "flag" / "outputs" / "visu")) \
        == names


def test_dataset_batches_cover_the_dataset_in_order():
    batches = list(tester.dataset_batches(_Indices(5), 2))
    assert [b["i"].tolist() for b in batches] == [[0, 1], [2, 3], [4]]


@pytest.fixture(scope="module")
def trained(kitti_root, tmp_path_factory):
    """``main`` for two epochs of one step each, ``tester.mode: all``."""
    tmp = tmp_path_factory.mktemp("cli")
    cfg = {"random_seed": 444, "dataset": _dataset_cfg(kitti_root),
           "model": MODEL_CFG,
           "optimizer": {"type": "adamw", "lr": 2e-4, "weight_decay": 1e-4},
           "lr_scheduler": {"type": "step", "decay_list": [125, 165]},
           "trainer": {"max_epoch": 2, "save_frequency": 1,
                       "save_path": str(tmp / "out")},
           "tester": {"threshold": 0.0, "topk": 10, "mode": "all"}}
    cfg_path = tmp / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    record = cli.main(["--config", str(cfg_path), "--device", "cpu"])
    data = tmp / "out" / "outputs" / "data"
    files = {p.name: p.read_bytes() for p in sorted(data.iterdir())}
    return dict(cfg_path=str(cfg_path), out=tmp / "out", record=record,
                files=files, data=data)


def test_main_trains_checkpoints_tests_and_tracks_best(trained):
    out, record = trained["out"], trained["record"]
    assert record["device"] == "cpu" and record["start_epoch"] == 0
    assert [len(e["loss_total"]) for e in record["epochs"]] == [1, 1]
    assert all(np.isfinite(e["loss_total"]).all() for e in record["epochs"])
    assert record["epochs"][0]["losses"]["grad_norm"] > 0
    names = sorted(os.listdir(out))
    assert [n for n in names if n.startswith("checkpoint")] == [
        "checkpoint_epoch_1", "checkpoint_epoch_1.meta",
        "checkpoint_epoch_2", "checkpoint_epoch_2.meta"]
    assert (out / "checkpoint_epoch_1.meta").read_text().startswith(
        "epoch=1\n")
    best = ckpt_io.list_checkpoints(str(out), tag="best")
    assert len(best) >= 1 and os.path.exists(best[-1] + ".meta")
    assert record["best_ap"] >= 0.0
    assert sorted(trained["files"]) == ["000002.txt", "000003.txt"]
    assert all(len(b.splitlines()) == 10 for b in trained["files"].values())
    evals = record["evaluated"]
    assert [e["checkpoint"] for e in evals] == ["checkpoint_epoch_1",
                                                "checkpoint_epoch_2"]
    for e in evals:
        assert len(e["results"]) == 6 and e["inference"] > 0 and e["ap"] > 0
    # the optimizer's count went into the checkpoint: one step per epoch
    payload = torch.load(out / "checkpoint_epoch_2", weights_only=True)
    assert payload["step"] == 2 and payload["epoch"] == 2


def test_evaluate_only_resumes_and_rewrites_the_same_files(trained, capsys):
    for p in trained["data"].iterdir():
        p.unlink()
    record = cli.main(["--config", trained["cfg_path"], "--device", "cpu",
                       "-e", "--ckpt",
                       str(trained["out"] / "checkpoint_epoch_2")])
    out = capsys.readouterr().out
    assert "resumed from" in out and "(epoch 2)" in out
    assert record["start_epoch"] == 2 and not record["epochs"]
    assert [e["checkpoint"] for e in record["evaluated"]] == [
        "checkpoint_epoch_2"]
    again = {p.name: p.read_bytes() for p in sorted(trained["data"].iterdir())}
    assert again == trained["files"]          # byte for byte


def test_tester_mode_all_sweeps_best_first_then_epochs(trained, capsys):
    record = cli.main(["--config", trained["cfg_path"], "--device", "cpu",
                       "--evaluate_only"])
    out = capsys.readouterr().out
    evals = [ln for ln in out.splitlines() if ln.startswith("== evaluating")]
    assert len(evals) == 3
    assert "best" in evals[0]
    assert "checkpoint_epoch_1" in evals[1]
    assert "checkpoint_epoch_2" in evals[2]
    assert [e["epoch"] for e in record["evaluated"][1:]] == [1, 2]
    # the sweep ends on epoch 2's weights: its files again
    again = {p.name: p.read_bytes() for p in sorted(trained["data"].iterdir())}
    assert again == trained["files"]


def test_continue_train_resumes_from_the_latest_checkpoint(trained, tmp_path,
                                                           capsys):
    cfg = yaml.safe_load(open(trained["cfg_path"]))
    cfg["continue_train"] = True
    cfg["trainer"]["max_epoch"] = 2           # already reached: no epoch runs
    path = tmp_path / "cfg_continue.yaml"
    path.write_text(yaml.safe_dump(cfg))
    record = cli.main(["--config", str(path), "--device", "cpu"])
    assert record["start_epoch"] == 2 and record["epochs"] == []
    assert "checkpoint_epoch_2 (epoch 2)" in capsys.readouterr().out


def test_sample_dataset_has_the_file_datasets_keys(kitti_root, tmp_path):
    ds_cfg = _dataset_cfg(kitti_root)
    real = KittiDetectionDataset(str(kitti_root), "val", ds_cfg)[0]
    ds = SampleDataset(3, ds_cfg, first_id=40)
    sample = ds[1]
    assert list(sample) == list(real)
    for k, v in real.items():
        assert np.asarray(sample[k]).shape == np.asarray(v).shape, k
        assert np.asarray(sample[k]).dtype == np.asarray(v).dtype, k
    assert ds.idx_list == ["000040", "000041", "000042"] and len(ds) == 3
    assert int(sample["img_id"]) == 41 and sample["valid"].sum() == 3
    assert sample["mask_2d"].sum() == 3 and (sample["depth"][:3] > 0).all()
    np.testing.assert_array_equal(ds[1]["image"], sample["image"])  # seeded
    # its label files read back as the cars it encodes
    write_sample_labels(str(tmp_path), ds)
    from monosowa_tpu_torch.kittiio import read_label_file
    labels = read_label_file(str(tmp_path / "000041.txt"))
    assert labels.names == ["Car"] * 3
    np.testing.assert_allclose(
        labels.pos[:, 2] * float(sample["canonical_scale"]),
        sample["depth"][:3], rtol=1e-6)
