"""Traffic driver ``detector_train``: a closed loop of the port's training
steps (``train/trainer.py`` ``make_train_step``) fed by the port's loader
(``data/loader.py`` ``build_loader`` over ``data/kitti_dataset.py``
``KittiDetectionDataset``), as ``tools/train_val_torch.py`` runs an epoch.

Set-up writes a KITTI-layout ``training`` split from the seed under the
run's temporary directory (``image_2/`` PNG, ``calib/``, ``label_2/``,
``ImageSets/train.txt``): ``distinct_images`` images and one calibration
(KITTI's P2), the other entries links to them, and for every entry its own
label rows as KITTI's ``label_2`` files hold them (``split_rows``): Cars (a
count from ``cars_per_image``) clear, occluded, far, truncated or hidden
at KITTI's shares and the other classes at KITTI's rates, mixed in a
seeded order, then the ``DontCare`` rows.  It builds the model, fills it
with the seed's weights, and takes the first three steps through the
loader and the step the window uses; the reference follows those three.
"""

from __future__ import annotations

import contextlib
import math
import os
import shutil
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

import bench_flops as bf
from bench_harness import Spans, seeded_frame
from bench_weights import float_shapes, load_into, seeded_state, sub_seed

CHECK_STEPS = 3
BETA1 = 0.9


# ---------------------------------------------------------------------------
# the split
# ---------------------------------------------------------------------------

def _corners(h, w, l, x, y, z, ry) -> np.ndarray:
    """(8, 3) corners of a KITTI box (bottom centre x, y, z)."""
    xs = np.array([l, l, -l, -l, l, l, -l, -l]) / 2
    ys = np.array([0, 0, 0, 0, -h, -h, -h, -h], float)
    zs = np.array([w, -w, -w, w, w, -w, -w, w]) / 2
    c, s = np.cos(ry), np.sin(ry)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    return (rot @ np.stack([xs, ys, zs])).T + np.array([x, y, z])


def _project(p2: np.ndarray, pts: np.ndarray) -> np.ndarray:
    hom = np.concatenate([pts, np.ones((len(pts), 1))], 1) @ p2.T
    return hom[:, :2] / hom[:, 2:3]


# the states of a Car row in a KITTI label file; the port trains on the
# first two (``obj_level`` below 4) and leaves the others out
CAR_STATES = ("clear", "occluded", "far", "truncated", "hidden")


def draw_box(rng, p2: np.ndarray, img_w: int, img_h: int,
             depth: Sequence[float], hwl, tall: Sequence[float],
             edge: bool = False):
    """(box, alpha, h, w, l, x, y, z, ry, truncation) of one object on the
    ground (camera 1.65 m above it) between ``depth`` metres whose box is
    from ``tall[0]`` to under ``tall[1]`` px tall: whole in the frame, or
    with ``edge`` cut by its left or right side so that more than half of
    its width is out (the box clipped to the frame, as KITTI's are)."""
    for _ in range(20000):
        z = rng.uniform(*depth)
        side = rng.uniform(-0.15, 0.02) if rng.random() < 0.5 \
            else rng.uniform(0.98, 1.15)
        u = (side if edge else rng.uniform(0.05, 0.95)) * img_w
        x = (u - p2[0, 2]) * z / p2[0, 0]
        h, w, l = np.asarray(hwl) * rng.uniform(0.9, 1.1, 3)
        ry = rng.uniform(-np.pi, np.pi)
        y = 1.65
        box = _project(p2, _corners(h, w, l, x, y, z, ry))
        x1, y1 = box.min(0)
        x2, y2 = box.max(0)
        trunc = 0.0
        if edge:
            cx1, cx2 = max(x1, 0.0), min(x2, img_w - 1.0)
            trunc = 1 - (cx2 - cx1) / (x2 - x1)
            if cx2 - cx1 < 2 or not 0.5 < trunc < 0.95:
                continue
            x1, x2 = cx1, cx2
        elif x1 < 1 or x2 > img_w - 2:
            continue
        if y1 < 2 or y2 > img_h - 3 or not tall[0] <= y2 - y1 + 1 < tall[1]:
            continue
        alpha = ry - np.arctan2(x, z)
        alpha = (alpha + np.pi) % (2 * np.pi) - np.pi
        return (x1, y1, x2, y2), alpha, h, w, l, x, y, z, ry, trunc
    raise ValueError(f"no box of {hwl} m between {depth} m is {tall} px tall"
                     f" in a {img_w} x {img_h} frame"
                     + (" and cut by its edge" if edge else ""))


def label_row(cls: str, state: str, rng, traffic: Dict[str, Any],
              p2: np.ndarray, img_w: int, img_h: int) -> str:
    """One KITTI label row of class ``cls``; a Car, and any other class, in
    ``state`` (``CAR_STATES``, "" for clear): clear (occlusion 0, whole),
    occluded (1 or 2), far (under 25 px tall), truncated (more than half
    out of the frame) or hidden (occlusion 3)."""
    hwl = traffic["mean_hwl"][cls]
    occ = {"occluded": int(rng.integers(1, 3)), "hidden": 3}.get(state, 0)
    if state == "far":
        got = draw_box(rng, p2, img_w, img_h, traffic["far_depth_m"], hwl,
                       (4, 25))
    else:
        # a Car kept by the port is at least 25 px tall; the other classes'
        # rows are any size
        got = draw_box(rng, p2, img_w, img_h, traffic["near_depth_m"], hwl,
                       (26 if cls == "Car" else 4, img_h),
                       edge=state == "truncated")
    (x1, y1, x2, y2), alpha, h, w, l, x, y, z, ry, trunc = got
    return (f"{cls} {trunc:.2f} {occ} {alpha:.2f} {x1:.2f} {y1:.2f} "
            f"{x2:.2f} {y2:.2f} {h:.2f} {w:.2f} {l:.2f} {x:.2f} {y:.2f} "
            f"{z:.2f} {ry:.2f}")


def spread(mean: float, n: int, rng) -> np.ndarray:
    """Counts for ``n`` images that sum to round(mean * n), each
    floor(mean) or one more, in a seeded order: every seed gets the same
    counts."""
    total = int(round(mean * n))
    base = total // n
    counts = np.full(n, base)
    counts[rng.permutation(n)[:total - base * n]] += 1
    return counts


def split_rows(traffic: Dict[str, Any], n: int, seed: int
               ) -> List[List[Tuple[str, str]]]:
    """Each image's label rows as (class, Car state or ""), in the order
    of its file: KITTI's classes mixed in a seeded order, the ``DontCare``
    rows last.  The counts of each class and of each Car state over the
    split are the same for every seed."""
    rng = np.random.default_rng(sub_seed(seed, 2))
    per = list(traffic["cars_per_image"])
    cars = np.asarray(per)[rng.permutation(n) % len(per)]
    total = int(cars.sum())
    states: List[str] = []
    for st in CAR_STATES[1:]:
        states += [st] * int(round(float(traffic["car_states"][st]) * total))
    states = ["clear"] * (total - len(states)) + states
    states = [states[i] for i in rng.permutation(total)]
    others = {cls: spread(float(m), n, rng)
              for cls, m in traffic["others_per_image"].items()}
    dontcare = spread(float(traffic["dontcare_per_image"]), n, rng)
    rows, k = [], 0
    for i in range(n):
        mine = [("Car", states[k + j]) for j in range(int(cars[i]))]
        k += int(cars[i])
        for cls, c in others.items():
            mine += [(cls, "")] * int(c[i])
        mine = [mine[j] for j in rng.permutation(len(mine))]
        rows.append(mine + [("DontCare", "")] * int(dontcare[i]))
    return rows


def write_split(root: str, traffic: Dict[str, Any], seed: int) -> List[str]:
    """The KITTI-layout ``training`` split of the traffic under ``root``;
    returns its ids."""
    from PIL import Image

    n = int(traffic["split_images"])
    n_img = int(traffic["distinct_images"])
    img_h, img_w = traffic["frame_hw"]
    p2 = np.array(traffic["calib_p2"], np.float64).reshape(3, 4)
    ids = [f"{i:06d}" for i in range(n)]
    train = os.path.join(root, "training")
    for sub in ("image_2", "calib", "label_2"):
        os.makedirs(os.path.join(train, sub))
    os.makedirs(os.path.join(root, "ImageSets"))
    with open(os.path.join(root, "ImageSets", "train.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")

    def png(i):
        # zlib's fastest level: set-up pays the encode in every run, and
        # inflating it costs the loader what a KITTI frame's does
        Image.fromarray(seeded_frame(sub_seed(seed, 1, i), img_h, img_w,
                                     int(traffic["image_block"]))).save(
            os.path.join(train, "image_2", f"{ids[i]}.png"),
            compress_level=1)

    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(png, range(n_img)))
    for i in range(n_img, n):
        os.symlink(f"{ids[i % n_img]}.png",
                   os.path.join(train, "image_2", f"{ids[i]}.png"))
    calib = "\n".join(
        [f"P{k}: " + " ".join(f"{v:.12e}" for v in p2.reshape(-1))
         for k in range(4)]
        + ["R0_rect: 1 0 0 0 1 0 0 0 1",
           "Tr_velo_to_cam: 1 0 0 0 0 1 0 0 0 0 1 0",
           "Tr_imu_to_velo: 1 0 0 0 0 1 0 0 0 0 1 0"]) + "\n"
    rng = np.random.default_rng(sub_seed(seed, 3))
    dontcare = "DontCare -1 -1 -10 {:.2f} {:.2f} {:.2f} {:.2f} -1 -1 -1 " \
        "-1000 -1000 -1000 -10"
    with open(os.path.join(train, "calib", f"{ids[0]}.txt"), "w") as f:
        f.write(calib)
    for idx, kinds in zip(ids, split_rows(traffic, n, seed)):
        if idx != ids[0]:
            os.symlink(f"{ids[0]}.txt",
                       os.path.join(train, "calib", f"{idx}.txt"))
        rows = []
        for cls, state in kinds:
            if cls == "DontCare":
                x1 = rng.uniform(0, img_w - 40)
                y1 = rng.uniform(0.4 * img_h, 0.85 * img_h)
                rows.append(dontcare.format(x1, y1, x1 + rng.uniform(10, 40),
                                            y1 + rng.uniform(8, 25)))
            else:
                rows.append(label_row(cls, state, rng, traffic, p2, img_w,
                                      img_h))
        with open(os.path.join(train, "label_2", f"{idx}.txt"), "w") as f:
            f.write("\n".join(rows) + "\n")
    return ids


@contextlib.contextmanager
def recorded_matches(alter: bool = False):
    """Records the assignments the criterion's matcher returns (the port's
    ``models/criterion.py`` calls ``hungarian_match`` by that name), as
    (B, G * Q) target slots; ``alter`` (a fault) swaps two queries'
    targets in each before the criterion sees it."""
    from monosowa_tpu_torch.models import criterion

    original = criterion.hungarian_match
    got: List[np.ndarray] = []

    def recording(*args, **kwargs):
        idx = original(*args, **kwargs)
        if alter:
            row = idx[0]
            hit = torch.nonzero(row >= 0)[:, 0]
            if len(hit) >= 2 and row[hit[0]] != row[hit[1]]:
                row[hit[0]], row[hit[1]] = row[hit[1]].clone(), \
                    row[hit[0]].clone()
        got.append(idx.cpu().numpy().copy())
        return idx

    criterion.hungarian_match = recording
    try:
        yield got
    finally:
        criterion.hungarian_match = original


def epochs(loader):
    """The loader's batches, epoch after epoch."""
    while True:
        yield from loader()


# ---------------------------------------------------------------------------
# the cell
# ---------------------------------------------------------------------------

class Cell:
    """One run of a ``detector_train`` cell: ``setup``, ``step`` (one
    training step on the next batch), ``close_window``, ``counts``,
    ``check``."""

    def __init__(self, config: Dict[str, Any], traffic: Dict[str, Any],
                 seed: int, dev: torch.device, trace: bool, reference,
                 fault: Optional[str] = None):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.dev, self.trace, self.ref = dev, trace, reference
        self.fault = fault
        self.spans = Spans()
        self.units = self.attempted = self.failed = 0
        self.batch = int(config["dataset"]["batch_size"])
        self.hw = tuple(int(v) for v in
                        config["dataset"].get("resolution", [1280, 384]))[::-1]

    # -- set-up ------------------------------------------------------------
    def setup(self) -> None:
        from monosowa_tpu_torch.data.kitti_dataset import \
            KittiDetectionDataset
        from monosowa_tpu_torch.data.loader import build_loader
        from monosowa_tpu_torch.models.monodetr import build_monodetr
        from monosowa_tpu_torch.train.optim import (make_lr_schedule,
                                                    make_optimizer)
        from monosowa_tpu_torch.train.trainer import (
            criterion_config_from_yaml, make_train_step)

        cfg, tr = self.config, self.traffic
        marks = [("start", time.time())]
        np.random.seed(sub_seed(self.seed, 4) % (1 << 32))
        self.root = tempfile.mkdtemp(prefix="monodetr-split-")
        self.ids = write_split(self.root, tr, self.seed)
        marks.append(("split", time.time()))
        ds_cfg = dict(cfg["dataset"], root_dir=self.root)
        dataset = KittiDetectionDataset(self.root, "train", ds_cfg)

        mcfg = cfg["model"]
        model = build_monodetr(mcfg, device=self.dev)
        self.shapes = float_shapes(model.state_dict())
        self.weight_seed = sub_seed(self.seed, 5)
        load_into(model, seeded_state(self.shapes, self.weight_seed,
                                      self.dev))
        opt = cfg["optimizer"]
        sch = cfg["lr_scheduler"]
        self.lr = float(opt["lr"])
        optimizer = make_optimizer(model, self.lr,
                                   float(opt["weight_decay"]))
        steps_per_epoch = max(len(dataset) // self.batch, 1)
        schedule = make_lr_schedule(
            self.lr, steps_per_epoch,
            decay_epochs=tuple(sch["decay_list"]),
            decay_rate=float(sch["decay_rate"]),
            warmup_epochs=5 if sch.get("warmup", False) else 0)
        self.train_step = make_train_step(
            model, criterion_config_from_yaml(model, mcfg), optimizer,
            schedule)
        self.model, self.optimizer = model, optimizer
        self.group_num = int(mcfg["group_num"])
        if int(model.group_num) != self.group_num:
            raise ValueError(f"the port built {model.group_num} query "
                             f"groups, the configuration states "
                             f"{self.group_num}")
        if self.fault == "unchanged":
            optimizer.step = lambda closure=None: None
        loader = build_loader(dataset, self.batch, shuffle=True,
                              seed=sub_seed(self.seed, 6),
                              workers=int(tr["loader_workers"]))
        self.batches = epochs(loader)
        self.dropout_seed = sub_seed(self.seed, 7)
        self.generator = torch.Generator(device=self.dev).manual_seed(
            self.dropout_seed)
        marks.append(("build", time.time()))

        # the first steps, through the window's own loader and step: they
        # warm every shape, and the reference follows them.  In the first
        # it takes the matcher's assignments as they were made (a rounding
        # can tip a near tie either way) and judges their cost; after it
        # the two sides' states differ by AdamW's rounding and each
        # matches its own
        self.first: List[Dict[str, Any]] = []
        names = dict((id(p), n) for n, p in model.named_parameters())
        for k in range(CHECK_STEPS):
            batch = next(self.batches)
            with recorded_matches(k == 0 and self.fault == "altered_match"
                                  ) as matches:
                losses = self._step(batch)
            self.first.append({
                "img_id": np.asarray(batch["img_id"]).copy(),
                "flip": np.asarray(batch["flip_flag"]).copy(),
                "loss": float(losses["loss_total"])})
            marks.append((f"step{k + 1}", time.time()))
            if k == 0:
                # the first gradient as the optimizer got it
                self.grad1 = {
                    names[id(p)]: (st["exp_avg"] / (1 - BETA1)).norm().item()
                    for p, st in optimizer.state.items()}
                # the criterion matches the last decoder layer, then the
                # others in order
                layers = int(mcfg["dec_layers"])
                order = [layers - 1] + list(range(layers - 1))
                self.matches = dict(zip(order, matches))
        self.params3 = {n: p.detach().to("cpu", copy=True)
                        for n, p in model.named_parameters()}
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.setup_phases = {b[0]: b[1] - a[1]
                             for a, b in zip(marks[:-1], marks[1:])}

    def _step(self, batch) -> Dict[str, float]:
        if self.fault == "half_batch":
            half = self.batch // 2
            batch = {k: v[:half] for k, v in batch.items()}
        losses = self.train_step(batch, self.generator)
        if self.fault == "altered":
            losses["loss_total"] *= 1.0 + 1e-3
        return losses

    # -- the window ----------------------------------------------------------
    def step(self) -> None:
        t0 = time.time()
        with torch.profiler.record_function("bench.loader_next"):
            batch = next(self.batches)
        t1 = time.time()
        with torch.profiler.record_function("bench.train_step"):
            losses = self._step(batch)
        t2 = time.time()
        self.spans.add("loader_wait", t1 - t0)
        self.spans.add("step", t2 - t1)
        self.attempted += 1
        if not math.isfinite(losses["loss_total"]):
            self.failed += 1
        else:
            self.units += self.batch

    def close_window(self) -> None:
        self.batches.close()

    def counts(self) -> Dict[str, Any]:
        mcfg = self.config["model"]
        queries = int(mcfg["num_queries"]) * self.group_num
        h, w = self.hw
        fwd = bf.monodetr_step(mcfg, self.batch, h, w, queries)
        return {"step_flops": bf.monodetr_train_flops(mcfg, self.batch, h, w,
                                                      queries),
                "msda_calls": fwd["msda_calls"]}

    # -- correctness ---------------------------------------------------------
    def check(self, limits: Dict[str, float]):
        """The first three steps against the reference: each step's loss,
        the first gradient's norm by leaf (from the optimizer's state after
        one step), the parameters' change by leaf after three steps."""
        del self.model, self.optimizer, self.train_step, self.batches
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        try:
            ref = self.ref.train_reference(
                self.config, self.root, self.first, self.shapes,
                self.weight_seed, self.dropout_seed, self.dev,
                steps=CHECK_STEPS,
                forced=[self.matches] + [None] * (CHECK_STEPS - 1))
        finally:
            shutil.rmtree(self.root, ignore_errors=True)
        p0 = seeded_state(self.shapes, self.weight_seed, self.dev)
        prog = {"loss": [s["loss"] for s in self.first],
                "grad": self.grad1,
                "change": {n: (p.to(self.dev) - p0[n]).norm().item()
                           for n, p in self.params3.items()}}
        numbers = compare_steps(prog, ref)
        self.diagnostics = explain_steps(prog, ref)
        checks = {k: {"value": v, "limit": limits[k]}
                  for k, v in numbers.items()}
        correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                      for c in checks.values())
        return correct, checks


def compare_steps(prog: Dict[str, Any], ref: Dict[str, Any]
                  ) -> Dict[str, float]:
    """The compared numbers: the worst gap by which the program's
    assignments fall short of the optimum under the reference's costs
    (``match``); the relative gap of the first step's loss (the
    later steps' losses follow Adam's first updates, whose signs on leaves
    with gradients at rounding level differ between any two sound runs);
    the widest gap between the program's and the reference's norm of a leaf's
    first gradient, and of its change over the steps, each against the
    larger of the reference's norm of that leaf and of the median leaf.
    Leaves whose first gradient in the reference is under a thousandth of
    the median leaf's move under Adam by round-off alone and are left out
    of the change."""
    loss_gap = abs(prog["loss"][0] - ref["loss"][0]) / abs(ref["loss"][0])
    g_ref = ref["grad"]
    g_med = float(np.median(list(g_ref.values())))
    grad_gap = max(abs(prog["grad"].get(n, 0.0) - g) / max(g, g_med)
                   for n, g in g_ref.items())
    moved = [n for n, g in g_ref.items() if g >= 1e-3 * g_med]
    c_ref = ref["change"]
    c_med = float(np.median([c_ref[n] for n in moved]))
    change_gap = max(abs(prog["change"][n] - c_ref[n])
                     / max(c_ref[n], c_med) for n in moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap, "match_gap": float(ref["match_gap"])}


def explain_steps(prog: Dict[str, Any], ref: Dict[str, Any]
                  ) -> Dict[str, Any]:
    """Where the compared numbers come from: each step's loss on both
    sides, and the leaves with the widest gaps of the first gradient and
    of the change, with their norms."""
    g_ref, c_ref = ref["grad"], ref["change"]
    g_med = float(np.median(list(g_ref.values())))
    moved = [n for n, g in g_ref.items() if g >= 1e-3 * g_med]
    c_med = float(np.median([c_ref[n] for n in moved]))

    def worst(p, r, names, med, k=3):
        gaps = sorted(((abs(p.get(n, 0.0) - r[n]) / max(r[n], med), n)
                       for n in names), reverse=True)[:k]
        return [[n, g, p.get(n, 0.0), r[n]] for g, n in gaps]

    return {"loss_prog": prog["loss"], "loss_ref": ref["loss"],
            "grad_median": g_med, "change_median": c_med,
            "leaves_left_out": len(g_ref) - len(moved),
            "grad_worst": worst(prog["grad"], g_ref, list(g_ref), g_med),
            "change_worst": worst(prog["change"], c_ref, moved, c_med)}


# ---------------------------------------------------------------------------
# the controls (``control.py``)
# ---------------------------------------------------------------------------

def controls(bench, cell, seed: int, dev, config: Dict[str, Any],
             traffic: Dict[str, Any], steps: int = CHECK_STEPS
             ) -> Dict[str, Any]:
    """The cell's numbers for TF32, for half of each batch and for an
    altered assignment, against the float32 reference, on the split and
    batches of ``seed`` (the first batches a loader would draw: distinct
    ids, seeded flips)."""
    from monosowa_tpu_torch.models.monodetr import build_monodetr

    ref = bench.reference(cell["config"])
    root = tempfile.mkdtemp(prefix="monodetr-control-")
    try:
        ids = write_split(root, traffic, seed)
        rng = np.random.default_rng(sub_seed(seed, 6))
        b = int(config["dataset"]["batch_size"])
        order = rng.permutation(len(ids))[:steps * b]
        first = [{"img_id": order[k * b:(k + 1) * b],
                  "flip": rng.random(b) < 0.5} for k in range(steps)]
        shapes = float_shapes(build_monodetr(config["model"],
                                             device="cpu").state_dict())
        args = (config, root, first, shapes, sub_seed(seed, 5),
                sub_seed(seed, 7), dev)
        base = ref.train_reference(*args, steps=steps)
        # TF32 in the program's place; the float32 reference takes its
        # first step's assignments, as it takes the program's
        tf32 = ref.train_reference(*args, steps=steps, tf32=True)
        rest = [None] * (steps - 1)
        out = {"tf32": compare_steps(tf32, ref.train_reference(
            *args, steps=steps, forced=tf32["matches"][:1] + rest))}
        half = ref.train_reference(*args, steps=steps, keep_only=b // 2)
        out["half_batch"] = compare_steps(half, base)
        # the matcher's answer altered: two queries of the first step's first
        # problem of each layer trade targets
        nq = int(config["model"]["num_queries"])
        altered = [{li: swap_first(rows, nq)
                    for li, rows in base["matches"][0].items()}]
        out["altered_match"] = ref.train_reference(
            *args, steps=steps, forced=altered + rest)["match_gap"]
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def swap_first(rows, nq: int):
    """(B, G * Q) target slots with the targets of two matched queries
    traded within the first problem (image and group of ``nq`` queries)
    that has two targets."""
    rows = rows.copy()
    for i in range(rows.shape[0]):
        for g0 in range(0, rows.shape[1], nq):
            hit = [g0 + q for q in range(nq) if rows[i, g0 + q] >= 0]
            if len(hit) >= 2:
                a, b = hit[0], hit[1]
                rows[i, a], rows[i, b] = rows[i, b], rows[i, a]
                return rows
    return rows
