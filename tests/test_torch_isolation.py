"""The torch port stands alone: no JAX, Flax or ``monosowa_tpu`` at run
time, and no quiet CPU fallback when the card is asked for."""

import ast
import json
import os
import subprocess
import sys

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
from monosowa_tpu_torch.train.optim import make_optimizer
from monosowa_tpu_torch.train.sample import sample_batch
from monosowa_tpu_torch.train.trainer import make_train_step
losses = make_train_step(model, None, make_optimizer(model))(
    sample_batch(1, h, w), torch.Generator().manual_seed(0))
print(json.dumps({"modules": names, "dets": list(dets.shape),
                  "finite": bool(np.isfinite(dets.numpy()).all()),
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
    """Every module imports, and a tiny CPU forward and train step run, in
    a fresh interpreter without loading JAX, Flax or the JAX package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", CHILD, ROOT], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "monosowa_tpu_torch.ops.msda" in res["modules"]
    assert res["dets"] == [1, 5, 37] and res["finite"]
    assert res["train_finite"] and res["grad_norm"] > 0
    assert res["loaded"] == []


@pytest.mark.parametrize("rel", ["chip_smoke.py", "monosowa_tpu_torch"])
def test_no_jax_imports_in_source(rel):
    path = os.path.join(ROOT, rel)
    files = [path] if path.endswith(".py") else [
        os.path.join(d, f) for d, _, fs in os.walk(path) for f in fs
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
    assert resolve_device("cpu").type == "cpu"


def test_unshipped_flags_raise():
    from monosowa_tpu_torch.models.monodetr import MonoDETR, build_monodetr

    for flag in ("two_stage", "use_dab", "use_depth"):
        with pytest.raises(NotImplementedError):
            MonoDETR(device="cpu", **{flag: True})
    with pytest.raises(NotImplementedError):
        MonoDETR(device="cpu", position_embedding="learned")
    with pytest.raises(NotImplementedError):
        build_monodetr({"use_dn": True}, device="cpu")
    with pytest.raises(NotImplementedError):
        MonoDETR(device="cpu", msda_backend="onehot")
