"""The torch port stands alone: no JAX, Flax or ``monosowa_tpu`` at run
time, and no quiet CPU fallback when the card is asked for."""

import ast
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "monosowa_tpu")

CHILD = r"""
import importlib, json, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
torch.set_num_threads(1)    # the suite runs six worker processes at once
import monosowa_tpu_torch
names = [m.name for m in pkgutil.walk_packages(monosowa_tpu_torch.__path__,
                                               "monosowa_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from monosowa_tpu_torch.models.monodetr import MonoDETR
from monosowa_tpu_torch.train.trainer import make_eval_step
model = MonoDETR(device="cpu", enc_layers=1, dec_layers=1, group_num=1,
                 d_model=64, d_ffn=64, nheads=4, num_queries=5,
                 num_depth_bins=8)
h, w = 64, 96
batch = {"image": np.random.default_rng(0).normal(
             size=(1, h, w, 3)).astype(np.float32),
         "calib": np.array([[[700.0, 0, w / 2, 0], [0, 700.0, h / 2, 0],
                             [0, 0, 1, 0]]], np.float32),
         "img_size": np.array([[w, h]], np.float32)}
dets = make_eval_step(model, topk=5)(batch)
# the bf16 policy on the CPU: bf16 activations, float32 heads
model16 = MonoDETR(device="cpu", enc_layers=1, dec_layers=1, group_num=1,
                   d_model=64, d_ffn=64, nheads=4, num_queries=5,
                   num_depth_bins=8, compute_dtype="bfloat16")
seen16 = {}
model16.encoder.layer0.self_attn.value_proj.register_forward_hook(
    lambda m, a, out: seen16.update(value_proj=str(out.dtype)))
dets16 = make_eval_step(model16, topk=5)(batch)
from monosowa_tpu_torch.train.optim import make_optimizer
from monosowa_tpu_torch.train.sample import sample_batch
from monosowa_tpu_torch.train.trainer import make_train_step
losses = make_train_step(model, None, make_optimizer(model))(
    sample_batch(1, h, w), torch.Generator().manual_seed(0))
# the pseudo-labeller: one tiny frame of the synthetic sequence
import tempfile
from monosowa_tpu_torch.kittiio import read_label_file
from monosowa_tpu_torch.sowa import pipeline, sample
from monosowa_tpu_torch.sowa.fitting import FitConfig
from monosowa_tpu_torch.sowa.templates import TemplateBank
frames, _ = sample.make_sequence(1, 2, h=94, w=310, n_cars=6)
labeler = pipeline.PseudoLabeler(
    pipeline.PipelineConfig(
        nscans_before=2, nscans_after=2, max_cars=4, max_points=256,
        min_standing_points=50,
        fit=FitConfig(n_dx=11, n_dz=11, n_theta=8, n_theta_fine=36)),
    bank=TemplateBank.default(num_points=100), device="cpu")
with tempfile.TemporaryDirectory() as tmp:
    jobs = sample.make_jobs(frames, 2, tmp, h=94, w=310)
    n_written = labeler.label_frames(jobs)
    label_rows = len(read_label_file(jobs[0]["out_path"]))
    # the same frame in bank mode (depth maps, device extraction)
    jobs = sample.make_jobs(frames, 2, tmp + "/bank", h=94, w=310,
                            with_depth=True)
    n_written += labeler.label_frames(jobs)
    bank_path = labeler.stage_seconds["bank_path"]
# the AP stack: the native library is built, two files are scored
from monosowa_tpu_torch.evalkitti import (annos_from_label_dir,
                                          get_official_eval_result, native)
from monosowa_tpu_torch.train.sample import (SampleDataset,
                                             write_sample_labels)
native.build()
ds_cfg = {"resolution": [w, h], "max_objs": 4, "batch_size": 1}
with tempfile.TemporaryDirectory() as tmp:
    val = SampleDataset(2, ds_cfg, first_id=2)
    write_sample_labels(tmp + "/training/label_2", val)
    gt = annos_from_label_dir(tmp + "/training/label_2", val.idx_list)
    ap = get_official_eval_result(gt, gt)["car_bbox_strict"]["ap40"]
    # the train / test / AP loop for one step
    sys.path.insert(0, sys.argv[1] + "/tools")
    import train_val_torch
    record = train_val_torch.run(
        {"dataset": dict(ds_cfg, root_dir=tmp),
         "model": {"enc_layers": 1, "dec_layers": 1, "hidden_dim": 64,
                   "dim_feedforward": 64, "nheads": 4, "num_queries": 5,
                   "num_depth_bins": 8},
         "trainer": {"max_epoch": 1, "save_path": tmp + "/out"},
         "tester": {"threshold": 0.0, "topk": 5}},
        SampleDataset(1, ds_cfg), val, "cpu", logger=lambda s: None)
    import os
    saved = sorted(os.listdir(tmp + "/out"))
    result_files = sorted(os.listdir(tmp + "/out/outputs/data"))
# the model zoo: tiny Mask2Former and Depth Anything through zoo
# checkpoints and the backends
from monosowa_tpu_torch.convert import zoo_params
from monosowa_tpu_torch.models import depth_anything, dinov2, mask2former
from monosowa_tpu_torch.models import swin
from monosowa_tpu_torch.sowa import zoo
from monosowa_tpu_torch.sowa.depth import DepthAnythingBackend
from monosowa_tpu_torch.sowa.masks import Mask2FormerBackend
mcfg = mask2former.Mask2FormerConfig(
    backbone=swin.SwinConfig(embed_dim=16, depths=(1, 1, 1, 1),
                             num_heads=(1, 2, 4, 8), window_size=4),
    feature_size=32, mask_feature_size=32, hidden_dim=32, encoder_layers=1,
    decoder_layers=2, num_attention_heads=2, encoder_feedforward_dim=32,
    dim_feedforward=32, num_queries=6, num_labels=3)
dcfg = depth_anything.DepthAnythingConfig(
    backbone=dinov2.Dinov2Config(hidden_size=32, num_hidden_layers=2,
                                 num_attention_heads=2, pos_grid=4),
    out_indices=(1, 2), reassemble_factors=(4.0, 0.5),
    neck_hidden_sizes=(8, 16), fusion_hidden_size=16, head_hidden_size=8,
    depth_estimation_type="metric", max_depth=80.0)
image = np.random.default_rng(1).integers(0, 256, (40, 60, 3), np.uint8)
with tempfile.TemporaryDirectory() as tmp:
    zoo.save_checkpoint(tmp + "/m.npz", "mask2former", zoo_params(
        mask2former.Mask2Former(mcfg, device="cpu")), mcfg)
    zoo.save_checkpoint(tmp + "/d.npz", "depth_anything", zoo_params(
        depth_anything.DepthAnything(dcfg, device="cpu")), dcfg)
    _, mtree, mcfg = zoo.load_checkpoint(tmp + "/m.npz")
    _, dtree, dcfg = zoo.load_checkpoint(tmp + "/d.npz")
zoo_masks = Mask2FormerBackend(mtree, mcfg, score_threshold=0.0,
                               input_hw=(64, 96),
                               device="cpu").predict_masks(image)
zoo_depth = DepthAnythingBackend(dtree, dcfg, fx=500.0, input_size=28,
                                 device="cpu").predict_depth(image)
# the labeller's poses, size stages and outlier ensemble
from monosowa_tpu_torch.kittiio import oxts_to_poses
from monosowa_tpu_torch.sowa import dimensions, filtering, scale, transforms
cam_poses = oxts_to_poses(np.array([[49.0, 8.4, 110.0, 0.0, 0.0, 0.1],
                                    [49.00001, 8.4, 110.0, 0.0, 0.0, 0.1]]))
k360 = transforms.k360_window_transforms(cam_poses, 1, 1, 1)
tb = TemplateBank.default(num_points=60)
cloud = (tb.points[1] + np.array([0.3, 1.0, 10.0])).astype(np.float32)
sres = scale.optimize_scale(
    torch.from_numpy(cloud), torch.ones(60, dtype=torch.bool),
    torch.from_numpy(tb.points), torch.tensor([0.3, 1.0, 10.0, 0.2]))
outlier_keep = filtering.ensemble_inlier_mask_host(
    np.random.default_rng(0).normal(size=(80, 3)), device="cpu")
dims, _ = dimensions.estimate_car_dimensions(
    (cloud - cloud.mean(0))[None], np.ones((1, 60), bool), cloud.mean(0),
    device="cpu")
# the Waymo converter's schema and tool, data parallelism at world size 1
from monosowa_tpu_torch.waymo import dataset_pb2 as waymo_pb2
import waymo_to_kitti_projected_torch
from monosowa_tpu_torch.parallel import setup
dp = setup(2, "cpu")
print(json.dumps({"modules": names, "dets": list(dets.shape),
                  "poses": [list(k360.shape), float(k360[2, 2, 3]),
                            float(sres.loss), int(outlier_keep.sum()),
                            dims.tolist()],
                  "waymo": [type(waymo_pb2.Frame()).__name__,
                            waymo_pb2.DESCRIPTOR.package,
                            "waymo_dataset_pb2" in sys.modules],
                  "dp": [dp.rank, dp.size, dp.group is None],
                  "ap_of_gt": ap, "saved": saved,
                  "result_files": result_files,
                  "epoch_losses": record["epochs"][0]["loss_total"],
                  "ap_keys": sorted(record["evaluated"][0]["results"]),
                  "frames_written": n_written, "label_rows": label_rows,
                  "bank_path": bank_path,
                  "zoo": [[list(m.shape) for m in zoo_masks][:1],
                          list(zoo_depth.shape),
                          bool(np.isfinite(zoo_depth).all())],
                  "finite": bool(np.isfinite(dets.numpy()).all()),
                  "bf16": [seen16["value_proj"], str(dets16.dtype),
                           bool(np.isfinite(dets16.numpy()).all())],
                  "train_finite": bool(np.isfinite(list(losses.values())
                                                   ).all()),
                  "grad_norm": losses["grad_norm"],
                  "loaded": sorted(m for m in sys.modules
                                   if m.split(".")[0] in %r)}))
""" % (FORBIDDEN,)


def _top_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_port_runs_without_jax():
    """Every module imports, and a tiny CPU forward (float32 and under the
    bfloat16 policy), a train step, the
    labelling of one small frame (host candidates, then bank mode), a
    KITTI-360 pose window, the scale detector, the outlier ensemble and
    the dimension estimator, the
    AP stack with its native library,
    one step of the train / test / AP loop and the model zoo's two
    backends from their checkpoints run, in a fresh interpreter
    without loading JAX, Flax or the JAX package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", CHILD, ROOT], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "monosowa_tpu_torch.ops.msda" in res["modules"]
    assert res["dets"] == [1, 5, 37] and res["finite"]
    assert res["bf16"] == ["torch.bfloat16", "torch.float32", True]
    assert res["train_finite"] and res["grad_norm"] > 0
    assert "monosowa_tpu_torch.sowa.pipeline" in res["modules"]
    assert "monosowa_tpu_torch.ops.tfl" in res["modules"]
    assert res["frames_written"] == 2 and res["label_rows"] >= 1
    assert res["bank_path"] == 1.0
    assert "monosowa_tpu_torch.evalkitti.native" in res["modules"]
    assert "monosowa_tpu_torch.ops.row_fetch" in res["modules"]
    assert max(res["ap_of_gt"]) > 0
    assert len(res["epoch_losses"]) == 1
    assert np.isfinite(res["epoch_losses"][0])
    assert res["saved"] == ["best_epoch_1", "best_epoch_1.meta",
                            "checkpoint_epoch_1", "checkpoint_epoch_1.meta",
                            "outputs"]
    assert res["result_files"] == ["000002.txt", "000003.txt"]
    assert len(res["ap_keys"]) == 6
    assert "monosowa_tpu_torch.sowa.zoo" in res["modules"]
    assert "monosowa_tpu_torch.models.mask2former" in res["modules"]
    assert res["zoo"] in ([[], [40, 60], True], [[[40, 60]], [40, 60], True])
    for module in ("kittiio.oxts", "sowa.transforms", "sowa.scale",
                   "sowa.dimensions", "sowa.filtering", "sowa.hdbscan_np"):
        assert "monosowa_tpu_torch." + module in res["modules"], module
    shape, dz, scale_loss, kept, dims = res["poses"]
    assert shape == [3, 4, 4] and dz == 0.0 and -2.0 <= scale_loss < -0.5
    assert 0 < kept <= 80 and dims == pytest.approx([3.88, 1.63, 1.526])
    for module in ("parallel.dist", "waymo.tfrecord", "waymo.frame_utils",
                   "sowa.visualization"):
        assert "monosowa_tpu_torch." + module in res["modules"], module
    # the port's own schema module, not the JAX package's
    assert res["waymo"] == ["Frame", "monosowa_torch.waymo", False]
    assert res["dp"] == [0, 1, True]
    assert res["loaded"] == []


@pytest.mark.parametrize("rel", ["chip_smoke.py", "monosowa_tpu_torch",
                                 "tools/*_torch*.py"])
def test_no_jax_imports_in_source(rel):
    path = os.path.join(ROOT, rel)
    if "*" in rel:
        files = glob.glob(path)
        assert len(files) >= 5            # the two tools and three profilers
    elif path.endswith(".py"):
        files = [path]
    else:
        files = [os.path.join(d, f) for d, _, fs in os.walk(path) for f in fs
                 if f.endswith(".py")]
    assert files
    for f in files:
        bad = [m for m in _top_imports(f) if m in FORBIDDEN]
        assert not bad, f"{f} imports {bad}"


def test_cuda_request_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-fallback check needs none")
    from monosowa_tpu_torch import resolve_device
    from monosowa_tpu_torch.models.monodetr import MonoDETR

    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()                    # the default is the card
    with pytest.raises(RuntimeError, match="cuda"):
        MonoDETR(enc_layers=1, dec_layers=1, d_model=64, d_ffn=64,
                 nheads=4, num_queries=5, num_depth_bins=8)
    from monosowa_tpu_torch.models.depth_anything import (
        DepthAnything, DepthAnythingConfig)
    from monosowa_tpu_torch.models.dinov2 import Dinov2Config
    from monosowa_tpu_torch.models.mask2former import (Mask2Former,
                                                       Mask2FormerConfig)
    from monosowa_tpu_torch.models.swin import SwinConfig

    with pytest.raises(RuntimeError, match="cuda"):
        Mask2Former(Mask2FormerConfig(backbone=SwinConfig()))
    with pytest.raises(RuntimeError, match="cuda"):
        DepthAnything(DepthAnythingConfig(backbone=Dinov2Config()))
    assert resolve_device("cpu").type == "cpu"


def test_unshipped_flags_raise(tmp_path):
    """What the port still refuses: a feature-level count other than 4
    (the JAX model cannot run one either), use_dn and no box refinement in
    a yaml (the JAX ``build_monodetr`` ignores both), and the auction
    kernel past 1,024 rows (the two-stage encoder match).  The one-hot MSDA
    backend and the prediction renders (``visu``,
    ``tester.visu_predictions``) are ported: a model with
    ``msda_backend: onehot`` builds and answers, and inference with either
    flag writes its renders (tests/test_torch_msda_onehot.py and
    tests/test_torch_visualization.py hold them against the JAX package).
    The variants the JAX ``build_monodetr`` reads are built
    (tests/test_torch_detector_variants.py holds them)."""
    from monosowa_tpu_torch.models.monodetr import MonoDETR, build_monodetr
    from monosowa_tpu_torch.ops import lap
    from monosowa_tpu_torch.train import tester
    from monosowa_tpu_torch.train.sample import (SampleDataset,
                                                 write_sample_labels)

    tiny = dict(enc_layers=1, dec_layers=1, d_model=64, d_ffn=64, nheads=4,
                num_queries=5, num_depth_bins=8)
    for levels in (3, 5):
        with pytest.raises(NotImplementedError):
            MonoDETR(device="cpu", num_feature_levels=levels, **tiny)
    for flag, value in (("use_dn", True), ("with_box_refine", False)):
        with pytest.raises(NotImplementedError):
            build_monodetr({flag: value}, device="cpu")
    for flags in ({"two_stage": True}, {"use_dab": True}, {"use_depth": True},
                  {"position_embedding": "learned"}):
        MonoDETR(device="cpu", **tiny, **flags)
    onehot = build_monodetr({"enc_layers": 1, "dec_layers": 1,
                             "hidden_dim": 64, "dim_feedforward": 64,
                             "nheads": 4, "num_queries": 5,
                             "num_depth_bins": 8, "msda_backend": "onehot"},
                            device="cpu")
    ds_cfg = {"resolution": [96, 64], "max_objs": 4, "batch_size": 2,
              "root_dir": str(tmp_path)}
    ds = SampleDataset(2, ds_cfg)
    write_sample_labels(str(tmp_path / "training" / "label_2"), ds)
    for i, tester_cfg in enumerate(({}, {"visu_predictions": True})):
        cfg = {"dataset": ds_cfg, "trainer": {"save_path": str(
            tmp_path / f"out{i}")}, "tester": {"topk": 5, **tester_cfg}}
        out = tester.run_inference(onehot, tester.dataset_batches(ds, 2),
                                   cfg, lambda s: None, visu=i == 0)
        assert sorted(os.listdir(out)) == ["000000.txt", "000001.txt"]
        assert sorted(os.listdir(tmp_path / f"out{i}" / "outputs" /
                                 "visu")) == ["000000.png", "000001.png"]
    tall = torch.zeros(1, lap.AUCTION_MAX_Q + 1, 50)
    with pytest.raises(ValueError, match="lap_auction"):
        lap._launch_auction(tall, torch.ones(1, dtype=torch.int64),
                            lap.AUCTION_PHASES, lap.AUCTION_ROUNDS)


TOOLS_CHILD = r"""
import json, os, runpy, sys
# none of these importable, as on the card's machine
for name in ("jax", "jaxlib", "flax", "optax", "transformers",
             "safetensors", "monosowa_tpu"):
    sys.modules[name] = None
root, work = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)


def run(tool, *args):
    sys.argv = [tool, *args]
    try:
        runpy.run_path(os.path.join(root, "tools", tool), run_name="__main__")
    except SystemExit as e:
        if e.code not in (0, None):
            raise


for kind in ("mask2former", "depth_anything", "sam", "loftr"):
    run("import_zoo_checkpoint_torch.py", "--kind", kind, "--hf",
        os.path.join(work, kind), "--out", os.path.join(work, kind + ".npz"))
run("kitti_raw_transforms_torch.py", work, "drive0",
    os.path.join(work, "transforms"), "--range", "2")
run("eval_dimensions_torch.py", os.path.join(work, "labels"),
    os.path.join(work, "labels"))
from monosowa_tpu_torch.sowa import zoo
kinds = [zoo.load_checkpoint(os.path.join(work, k + ".npz"))[0]
         for k in ("mask2former", "depth_anything", "sam", "loftr")]
print(json.dumps({"kinds": kinds,
                  "transforms": sorted(os.listdir(os.path.join(
                      work, "transforms"))),
                  "loaded": sorted(m for m in sys.modules
                                   if sys.modules[m] is not None and
                                   m.split(".")[0] in %r)}))
""" % (FORBIDDEN + ("transformers", "safetensors"),)


def test_tools_run_without_jax_or_transformers(tmp_path):
    """The import tool on four ``save_pretrained`` directories (the JAX
    parity tests' tiny models), the raw-sequence transforms tool and the
    dimension evaluation, in a fresh interpreter where ``jax``, ``flax``,
    ``optax``, ``transformers``, ``safetensors`` and the JAX package cannot
    be imported."""
    transformers = pytest.importorskip("transformers")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_raw_calib import _write_calibs
    from test_torch_import_hf import tiny_model

    for kind in ("mask2former", "depth_anything", "sam", "loftr"):
        tiny_model(kind).save_pretrained(str(tmp_path / kind))
    _write_calibs(tmp_path)
    oxts = tmp_path / "drive0" / "oxts" / "data"
    oxts.mkdir(parents=True)
    for i in range(3):
        vals = [49.0 + i * 1e-5, 8.43, 110.0, 0.0, 0.0, 1.5] + [0.0] * 24
        (oxts / f"{i:010d}.txt").write_text(" ".join(map(str, vals)))
    (tmp_path / "labels").mkdir()
    (tmp_path / "labels" / "000000.txt").write_text(
        "Car 0.00 0 0.00 10 10 50 50 1.5 1.6 3.9 1.00 1.60 9.00 0.10\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", TOOLS_CHILD, ROOT,
                           str(tmp_path)], env=env, capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["kinds"] == ["mask2former", "depth_anything", "sam", "loftr"]
    assert res["transforms"] == [f"{i:010d}.npy" for i in range(3)]
    assert res["loaded"] == []
