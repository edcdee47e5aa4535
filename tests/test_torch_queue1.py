"""The last of the JAX package's modules that the port lacked, against the
JAX functions and tools on the same inputs, on the CPU:

* ``ops/lap.py`` ``solve_lap_auction_fast``: assignments equal, problem
  for problem, on the JAX LAP tests' cost sets (tests/test_torch_lap.py's
  matrices of tests/test_matcher_criterion.py, its tie cases, 12 x 7);
* ``train/optim.py`` ``make_optimizer(grad_clip=)`` against the JAX
  ``make_optimizer`` (``optax.chain(clip_by_global_norm, adamw)``) on
  identical gradients above and below the clip: 1e-6 abs;
* ``ops/geometry.py`` ``random_downsample_mask`` with the JAX key's draws
  and ``models/depth_predictor.py`` ``lid_bin_index``: equal;
* ``utils/timing.py`` (stats and report on a fake clock, the trace file)
  and ``utils/logger.py`` (handlers, format, seeding): equal;
* ``sowa/cli.py`` ``_optimize_frame`` against the JAX driver's on the CLI
  tests' scene: the label file equal;
* ``tools/kitti_raw_transforms_torch.py`` and
  ``tools/eval_dimensions_torch.py`` against the JAX tools: the files and
  the results equal.
"""

import logging
import os
import random
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from monosowa_tpu.models import depth_predictor as jdp
from monosowa_tpu.ops import geometry as jgeometry
from monosowa_tpu.ops import lap as jlap
from monosowa_tpu.train import optim as joptim
from monosowa_tpu.utils import logger as jlogger
from monosowa_tpu.utils import timing as jtiming
from monosowa_tpu_torch.models import depth_predictor
from monosowa_tpu_torch.ops import geometry, lap
from monosowa_tpu_torch.train import optim
from monosowa_tpu_torch.utils import logger, timing

torch.set_num_threads(1)    # the suite runs six worker processes at once
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# solve_lap_auction_fast
# ---------------------------------------------------------------------------

def test_auction_fast_equals_jax():
    from test_torch_lap import _batch, _jax_each, _matcher_test_cases, \
        _tie_cases

    rng = np.random.default_rng(2)
    small = [(rng.normal(size=(12, 7)).astype(np.float32), m)
             for m in (7, 3, 0)]
    for cases in (small, _matcher_test_cases(), _tie_cases()):
        got = lap.solve_lap_auction_fast(*_batch(cases)).numpy()
        want = _jax_each(jlap.solve_lap_auction_fast, cases)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)
        for k, (_, m) in enumerate(cases):
            cols = got[k][got[k] >= 0]      # the rounds cap may leave some
            assert len(set(cols)) == len(cols) and (cols < m).all(), k


def test_auction_fast_batched_equals_each():
    from test_torch_lap import _batch, _matcher_test_cases

    cases = _matcher_test_cases()[:6]
    whole = lap.solve_lap_auction_fast(*_batch(cases)).numpy()
    for k, case in enumerate(cases):
        np.testing.assert_array_equal(
            whole[k], lap.solve_lap_auction_fast(*_batch([case])).numpy()[0])


# ---------------------------------------------------------------------------
# make_optimizer(grad_clip=)
# ---------------------------------------------------------------------------

class Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = nn.Linear(3, 4)
        self.norm = nn.LayerNorm(4)


@pytest.mark.parametrize("grad_scale", [0.05, 3.0], ids=["below", "above"])
def test_grad_clip_equals_optax(grad_scale):
    """Three AdamW steps with the gradients' global norm clipped at 1.0
    (below: the norm stays under it; above: every step is clipped), the
    same gradients on both sides."""
    clip, lr, wd = 1.0, 1e-2, 1e-2
    model = Tiny()
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(rng.normal(size=p.shape).astype(
                np.float32)))
    params = {"lin": {"kernel": model.lin.weight.detach().numpy().T.copy(),
                      "bias": model.lin.bias.detach().numpy().copy()},
              "norm": {"scale": model.norm.weight.detach().numpy().copy(),
                       "bias": model.norm.bias.detach().numpy().copy()}}
    params = jax.tree_util.tree_map(jnp.asarray, params)
    tx = joptim.make_optimizer(lr, wd, grad_clip=clip)
    state = tx.init(params)
    opt = optim.make_optimizer(model, lr, wd, grad_clip=clip)
    assert isinstance(opt, optim.ClippedAdamW)
    norms = []
    for _ in range(3):
        g = {k: rng.normal(size=p.shape).astype(np.float32) * grad_scale
             for k, p in model.named_parameters()}
        for k, p in model.named_parameters():
            p.grad = torch.from_numpy(g[k].copy())
        norms.append(float(np.sqrt(sum((v.astype(np.float64) ** 2).sum()
                                       for v in g.values()))))
        opt.step()
        grads = {"lin": {"kernel": g["lin.weight"].T, "bias": g["lin.bias"]},
                 "norm": {"scale": g["norm.weight"], "bias": g["norm.bias"]}}
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                   state, params)
        params = jax.tree_util.tree_map(lambda a, b: a + b, params, updates)
    assert (max(norms) < clip) if grad_scale < 1 else (min(norms) > clip)
    for got, want in ((model.lin.weight.detach().numpy().T,
                       params["lin"]["kernel"]),
                      (model.lin.bias.detach().numpy(),
                       params["lin"]["bias"]),
                      (model.norm.weight.detach().numpy(),
                       params["norm"]["scale"]),
                      (model.norm.bias.detach().numpy(),
                       params["norm"]["bias"])):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)


def test_grad_clip_rule_is_optax_not_clip_grad_norm():
    p = nn.Parameter(torch.zeros(4))
    p.grad = torch.tensor([3.0, 4.0, 0.0, 0.0])     # norm 5
    norm = optim.clip_by_global_norm([p], 2.0)
    assert float(norm) == 5.0
    np.testing.assert_array_equal(p.grad.numpy(),
                                  np.float32([3, 4, 0, 0]) / 5 * 2)
    assert type(optim.make_optimizer(Tiny())) is torch.optim.AdamW


# ---------------------------------------------------------------------------
# random_downsample_mask, lid_bin_index
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,valid,max_points", [(500, 0.6, 128),
                                                (500, 0.1, 128),
                                                (64, 1.0, 64), (64, 0.0, 8)])
def test_random_downsample_mask_with_the_jax_draws(n, valid, max_points):
    rng = np.random.default_rng(n + max_points)
    mask = rng.uniform(size=n) < valid
    key = jax.random.PRNGKey(3)
    want = np.asarray(jgeometry.random_downsample_mask(
        key, jnp.asarray(mask), max_points))
    scores = np.array(jax.random.uniform(key, mask.shape))
    got = geometry.random_downsample_mask(
        torch.from_numpy(mask), max_points, scores=torch.from_numpy(scores))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.sum() == min(max_points, mask.sum())
    drawn = geometry.random_downsample_mask(
        torch.from_numpy(mask), max_points,
        generator=torch.Generator().manual_seed(0))
    assert drawn.sum() == min(max_points, mask.sum())
    assert not (drawn & ~torch.from_numpy(mask)).any()


def test_lid_bin_index_equals_jax():
    nbins, dmin, dmax = 80, 1e-3, 60.0
    bin_size = 2 * (dmax - dmin) / (nbins * (1 + nbins))
    edges = (np.arange(nbins + 1) + 0.5) ** 2 * bin_size / 2 \
        - bin_size / 8 + dmin
    depth = np.concatenate([
        np.linspace(-5, 70, 20001), edges, np.nextafter(edges, 0),
        np.nextafter(edges, 100), [dmin, dmax, np.nextafter(dmin, 0),
                                   np.nextafter(dmax, 100), np.nan,
                                   np.inf, -np.inf, 0.0]]).astype(np.float32)
    want = np.asarray(jdp.lid_bin_index(jnp.asarray(depth), nbins, dmin,
                                        dmax))
    got = depth_predictor.lid_bin_index(torch.from_numpy(depth), nbins,
                                        dmin, dmax)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# StageTimer, the logger
# ---------------------------------------------------------------------------

def test_stage_timer_equals_jax(monkeypatch, tmp_path):
    timers = [timing.StageTimer(), jtiming.StageTimer()]
    for t in timers:
        clock = iter(np.cumsum([0.0, 0.013, 0.002, 0.031, 0.5, 0.0071, 1.0,
                                0.0042, 0.3, 0.02]).tolist())
        monkeypatch.setattr("time.perf_counter", lambda: next(clock))
        for name in ("fit", "load", "fit", "nms", "fit"):
            with t.stage(name):
                pass
    port, jax_ = timers
    assert port.report() == jax_.report()
    for name, s in jax_.stats.items():
        p = port.stats[name]
        assert (p.n, p.mean, p.m2, p.var) == (s.n, s.mean, s.m2, s.var)
    monkeypatch.undo()
    with port.trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")


def test_logger_equals_jax(tmp_path, capsys):
    loggers = [logger.create_logger(str(tmp_path / "port.log")),
               jlogger.create_logger(str(tmp_path / "jax.log"))]
    for lg in loggers:
        assert lg.level == logging.INFO
        assert [type(h) for h in lg.handlers] == [logging.FileHandler,
                                                  logging.StreamHandler]
        lg.info("epoch %d", 3)
        for h in lg.handlers:
            h.flush()
    fmts = [[h.formatter._fmt for h in lg.handlers] for lg in loggers]
    assert fmts[0] == fmts[1]
    tails = [(tmp_path / f).read_text().split("  ", 1)[1]
             for f in ("port.log", "jax.log")]
    assert tails[0] == tails[1] == " INFO  epoch 3\n"
    draws = []
    for set_seed in (logger.set_random_seed, jlogger.set_random_seed):
        set_seed(11)
        draws.append((random.random(), np.random.rand()))
    assert draws[0] == draws[1]


# ---------------------------------------------------------------------------
# the CLI's one-frame route
# ---------------------------------------------------------------------------

def test_optimize_frame_equals_jax(tmp_path):
    """One frame of the CLI tests' scene (pseudo-LiDAR windows under
    ``lidar_raw/<frame>/pcds/``) through each driver's ``_optimize_frame``:
    the label files equal; a second call writes nothing."""
    import test_torch_sowa_cli as scene
    from monosowa_tpu.sowa import cli as jcli
    from monosowa_tpu.sowa import depth as jdepth
    from monosowa_tpu.sowa.pipeline import PseudoLabeler as JaxLabeler
    from monosowa_tpu_torch.sowa import cli
    from monosowa_tpu_torch.sowa.pipeline import PseudoLabeler

    root = scene.kitti_dir.__wrapped__(_Factory(tmp_path))
    fid = scene.FIDS[0]
    pcds = root / "cache" / "lidar_raw" / fid / "pcds"
    pcds.mkdir(parents=True)
    for k in range(-scene.WINDOW, scene.WINDOW + 1):
        d, _ = scene._scene_depth(int(fid) + k)
        pts = jdepth.pseudo_lidar_from_depth(
            d * (jdepth.CANONICAL_FOCAL / scene.FU), scene.P2)
        np.savez_compressed(pcds / f"{k:+d}.npz", points=pts)
    out = {}
    for tag, mod, make in (("jax", jcli, lambda c: JaxLabeler(c)),
                           ("torch", cli,
                            lambda c: PseudoLabeler(c, device="cpu"))):
        conf = mod.load_config(scene._config(root, tag))
        kw = {} if tag == "jax" else {"device": "cpu"}
        drv = mod.KittiObjectDriver(conf, mod.PipelineFlags("optimization"),
                                    **kw)
        labeler = make(drv.pcfg)
        assert drv._optimize_frame(labeler, fid) == 1
        assert drv._optimize_frame(labeler, fid) == 0
        out[tag] = (root / tag / f"{fid}.txt").read_text()
    assert out["torch"] == out["jax"]
    assert out["torch"].startswith("Car ")


class _Factory:
    """The ``tmp_path_factory`` a module fixture takes, for one test."""

    def __init__(self, path):
        self.path = path

    def mktemp(self, name):
        p = self.path / name
        p.mkdir()
        return p


# ---------------------------------------------------------------------------
# the two tools
# ---------------------------------------------------------------------------

def test_kitti_raw_transforms_tool_equals_jax(tmp_path):
    from test_raw_calib import _write_calibs

    _write_calibs(tmp_path)
    oxts = tmp_path / "drive0" / "oxts" / "data"
    oxts.mkdir(parents=True)
    rng = np.random.default_rng(4)
    for i in range(7):
        vals = [49.0 + i * 1e-5, 8.43 + i * 3e-6, 110.0 + 0.1 * i,
                0.01 * rng.normal(), 0.01 * rng.normal(),
                np.pi / 2 + 0.02 * i] + [0.0] * 24
        (oxts / f"{i:010d}.txt").write_text(" ".join(str(v) for v in vals))
    outs = {}
    for tag, name in (("jax", "kitti_raw_transforms.py"),
                      ("torch", "kitti_raw_transforms_torch.py")):
        out = tmp_path / tag
        subprocess.run([sys.executable, os.path.join(ROOT, "tools", name),
                        str(tmp_path), "drive0", str(out), "--range", "3"],
                       check=True, capture_output=True,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
        outs[tag] = out
    files = sorted(os.listdir(outs["jax"]))
    assert files == sorted(os.listdir(outs["torch"])) and len(files) == 7
    for f in files:
        np.testing.assert_array_equal(np.load(outs["torch"] / f),
                                      np.load(outs["jax"] / f))


def test_eval_dimensions_tool_equals_jax(tmp_path):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import eval_dimensions as jtool
    import eval_dimensions_torch as tool

    rng = np.random.default_rng(9)
    gt, pred = tmp_path / "gt", tmp_path / "pred"
    gt.mkdir()
    pred.mkdir()
    for f in range(4):
        rows_g, rows_p = [], []
        for c in range(5):
            h, w, l = rng.uniform(1.4, 1.7), rng.uniform(1.5, 1.9), \
                rng.uniform(3.5, 4.8)
            x, z = rng.uniform(-10, 10), rng.uniform(5, 40)
            rows_g.append(f"Car 0.00 0 0.00 10 10 50 50 {h:.2f} {w:.2f} "
                          f"{l:.2f} {x:.2f} 1.60 {z:.2f} 0.10")
            if c < 4:
                rows_p.append(
                    f"Car 0.00 0 0.00 10 10 50 50 {h + 0.1:.2f} "
                    f"{w - 0.05:.2f} {l + rng.normal(0, 0.2):.2f} "
                    f"{x + rng.normal(0, 0.5 + 2 * c):.2f} 1.60 {z:.2f} "
                    "0.10 0.9")
        rows_p.append("Pedestrian 0.00 0 0.00 10 10 50 50 1.7 0.6 0.8 "
                      "1.00 1.60 9.00 0.10 0.8")
        (gt / f"{f:06d}.txt").write_text("\n".join(rows_g) + "\n")
        (pred / f"{f:06d}.txt").write_text("\n".join(rows_p) + "\n")
    got = tool.main(str(gt), str(pred))
    want = jtool.main(str(gt), str(pred))
    assert got == want and got["n_pairs"] > 4
