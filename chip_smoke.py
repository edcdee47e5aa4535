#!/usr/bin/env python3
"""Smoke run of the torch port (``monosowa_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. env    — TF32 off for matmuls and convolutions; the card's name and
            power limit as nvidia-smi reports them.
2. build  — nvcc builds every kernel of the serve, train, label and
            row-fetch paths from ``ops/csrc`` and the host compiler builds
            the KITTI evaluation's library from ``evalkitti/csrc``, one
            compiler per source, all started together.
3. kernel — each kernel against its plain PyTorch version at the paths'
            shapes (MSDA forward and backward: the encoder's B=2,
            Q=S=10,200 tokens, with offsets near the reference points and
            with wide ones, and the decoder's Q=50 at serving and Q=550 in
            training, each with the kernel's time inside a replayed CUDA
            graph, its time launched from Python, its block map and the
            levels it keeps in shared memory; the
            template-fitting coverage counts: the fit's rescore shape,
            48 cars x 40 poses, and its fine-pass shape, 4 cars x 360
            poses, of 1000 template points against 2048 scan points; the
            windowed row fetch, both forms: the micro-benchmark's 10,240
            rows of a 10,240 x 128 bf16 bank and the 163,200 quad rows one
            image and head of the encoder reads, difference 0 required),
            with error, times, the least time the card could take and,
            where one PyTorch call computes the same function, its time.
4. serve  — the full-width MonoDETR (ResNet-50, d_model 256, 3+3 layers,
            seeded random weights) answers three requests of two 384x1280
            images through ``run_inference``; the result files are read
            back, each kernel's launch count is checked, and one forward
            with the plain MSDA is compared with the kernel's.
5. train  — the same model in training mode (50 x 11 Group-DETR queries)
            on ``sample_batch(2, 384, 1280)``.  First, dropout off and from
            the seeded weights, one forward and backward with the kernels
            against one through the plain MSDA (loss dict, gradients) and
            one with the forward kernel and the plain backward (gradients:
            the backward kernel alone).  Then, dropout 0.1, a warm-up step
            and three timed steps of ``make_train_step`` with AdamW;
            losses, gradient norm and launch counts are checked.
6. fit    — ``fit_cars_conv`` at the full grid (41 x 41 translations,
            40 thetas, 360 fine thetas) on 16 synthetic cars at known
            poses, standing and moving: x and z within 0.35 m, yaw within
            6 degrees modulo pi; the coarse grid's rounded cuDNN
            correlations against the same correlations without cuDNN.
7. label  — the pseudo-labeller at full width: a synthetic 375x1242
            sequence (about 460k points a frame), one group of 8 reference
            frames with windows of +-6 frames through
            ``PseudoLabeler.label_frames`` (host candidates), one KITTI
            label file per frame, read back and held against the scene.
8. bench  — the row-fetch micro-benchmark as a user runs it
            (``tools/bench_gather_micro_torch.py`` ``run``, both forms at
            its default shape), against its numpy oracle.
9. epoch  — the loop of ``tools/train_val_torch.py`` ``run`` at full width
            on an in-memory KITTI-like dataset (8 training and 4 test
            images, batch 2): one epoch of 4 train steps, a checkpoint,
            ``test`` (inference, result files, KITTI AP through the native
            library), the best-by-Car-moderate-AP checkpoint; then
            evaluate-only from the checkpoint, which must rewrite the same
            result files byte for byte; and the AP stack on its own ground
            truth, which must score 100.
10. kernels — one line listing every ported kernel with its numbers.

The last line is ``{"ok": true, "device": {...}}``.  Any failed phase
raises and the script exits non-zero without it; so does a machine
without a GPU.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_FLOPS = 67e12            # H100 SXM float32 outside the tensor cores
ENC_SHAPES = ((48, 160), (24, 80), (12, 40), (6, 20))   # 384x1280 pyramid
M_HEADS, D_HEAD, N_POINTS = 8, 32, 4
IMG_H, IMG_W, BATCH, REQUESTS = 384, 1280, 2, 3
MSDA_PER_FORWARD = 6          # 3 encoder + 3 decoder layers
KERNELS = ("msda_fwd", "msda_bwd", "tfl_counts", "row_fetch")
TRAIN_STEPS = 3
TRAIN_QUERIES = 50 * 11       # num_queries x group_num
TFL_T, TFL_S, TFL_RADIUS = 1000, 2048, 0.2   # template, scan, threshold
TFL_PER_FIT = 3               # rescore, half-pitch refinement, fine pass
FIT_CARS = 16
LABEL_FRAMES, LABEL_WINDOW = 8, 6
# row fetch: the micro-benchmark's shape and the quad rows (4 levels x 4
# points per token) that one image and head of the encoder reads
RF_T, RF_D, RF_BQ = 10240, 128, 256
RF_ROWS = {"K6": RF_T, "encoder head": 10200 * 16}
EPOCH_TRAIN, EPOCH_VAL, PERFECT_IMAGES = 8, 4, 16
AP_KEYS = tuple(f"car_{m}_{s}" for s in ("strict", "loose")
                for m in ("bbox", "bev", "3d"))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean time in ms of ``iters`` calls of fn() launched back to back
    from Python (the device's time or the host's launch rate)."""
    from monosowa_tpu_torch.timing import launched_ms

    return launched_ms(fn, iters, warmup)


def device_ms(fn, iters: int) -> float:
    """Mean device time of fn() in ms inside a replayed CUDA graph."""
    from monosowa_tpu_torch.timing import device_ms as graph_ms

    return graph_ms(fn, iters)


def ptxas_registers(log: str) -> dict:
    """Registers and spilled bytes of each kernel in nvcc's ``-Xptxas -v``
    output, by mangled name (an MSDA kernel's ``ILi4ELi8E`` is its
    instantiation for 4 channels a lane and 8 lanes a query)."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '([^']+)'", line)
        if found:
            name = found.group(1)
            out[name] = {}
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill and name:
            out[name]["spill_bytes"] = int(spill.group(1)) \
                + int(spill.group(2))
        used = re.search(r"Used (\d+) registers", line)
        if used and name:
            out[name]["registers"] = int(used.group(1))
    return out


def msda_inputs(rng, q: int, ref, dev, wide: bool = False):
    """value, loc, aw for MSDA at the 384x1280 pyramid.  loc sits at the
    reference points plus ring-pattern offsets of the sampling-offset
    bias, jittered by half a pixel (an untrained model's offsets), or, with
    ``wide``, plus offsets with a standard deviation of 4 pixels of each
    level (far less local); 2% of the samples are redrawn in [-0.15, 1.15]
    so out-of-bounds corners are covered."""
    import numpy as np
    import torch

    from monosowa_tpu_torch.models.transformer import ring_bias

    b, m, d, p, n_lv = BATCH, M_HEADS, D_HEAD, N_POINTS, len(ENC_SHAPES)
    s = sum(h * w for h, w in ENC_SHAPES)
    ring = ring_bias(m, n_lv, p).reshape(1, 1, m, n_lv, p, 2)
    if wide:
        offs = rng.normal(0, 4.0, (b, q, m, n_lv, p, 2))
    else:
        offs = ring * rng.uniform(0.5, 1.5, (b, q, m, n_lv, p, 1)) \
            + rng.normal(0, 0.5, (b, q, m, n_lv, p, 2))
    norm = np.array([[w, h] for h, w in ENC_SHAPES], np.float32)
    loc = ref[:, :, None, :, None, :] + offs / norm[:, None, :]
    wild = rng.random((b, q, m, n_lv, p)) < 0.02
    loc[wild] = rng.uniform(-0.15, 1.15, (int(wild.sum()), 2))
    logits = rng.normal(size=(b, q, m, n_lv * p))
    aw = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    value = rng.normal(size=(b, s, m, d))
    return tuple(torch.from_numpy(a.astype(np.float32)).to(dev)
                 for a in (value, loc, aw.reshape(b, q, m, n_lv, p)))


def msda_bound(value, loc, other_elems: int, macs_per_corner: int):
    """Least time for the work: compulsory bytes over the memory rate, and
    the operations the in-bounds corners need (``macs_per_corner``
    multiply-adds per channel) over the float32 rate.  The bytes are
    ``other_elems`` float32 values (the other inputs read once and the
    outputs written once) and of value only the distinct (b, token, head)
    rows that some in-bounds corner of this run's samples reads, once each.
    Returns (bound_ms, bound_by, bytes, flops, corners per level,
    value_rows)."""
    import torch

    from monosowa_tpu_torch.ops.msda import _corner_geometry

    b, s, m, d = value.shape
    bi = torch.arange(b, device=loc.device).view(b, 1, 1, 1)
    mi = torch.arange(m, device=loc.device).view(1, 1, m, 1)
    keys, corners, start = [], [], 0
    for lvl, (h, w) in enumerate(ENC_SHAPES):
        corners.append(0)
        for flat, _, _, _, inb in _corner_geometry(loc[:, :, :, lvl], h, w):
            hit = inb > 0
            corners[lvl] += int(hit.sum().item())
            keys.append(((bi * s + start + flat) * m + mi)[hit])
        start += h * w
    value_rows = int(torch.unique(torch.cat(keys)).numel())
    nbytes = 4 * (value_rows * d + other_elems)
    flops = 2 * macs_per_corner * d * sum(corners)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    return (max(t_bytes, t_ops) * 1e3, bound_by, nbytes, flops, corners,
            value_rows)


def msda_report(label, q, value, loc, err, kernel, plain, bound, rows_moved
                ) -> dict:
    """The numbers of one MSDA kernel at one shape: its time inside a
    replayed CUDA graph and launched from Python, the plain version's time,
    the bound, the block map, and the rate at which corner rows are
    consumed: all of them, and those of the levels that are not resident in
    shared memory (the most that L2 can have served; what L1 serves lowers
    it further).  ``rows_moved`` is 1 for the forward (a row read) and 2
    for the backward (a row read and a row of adds)."""
    from monosowa_tpu_torch.ops import msda

    bound_ms, bound_by, nbytes, flops, corners, value_rows = bound
    plan = msda.msda_plan(ENC_SHAPES, q, N_POINTS, D_HEAD, value.device)
    row = D_HEAD * 4
    res = {
        "shape": f"{label}: B={BATCH} Q={q} S={value.shape[1]} "
                 f"M={M_HEADS} D={D_HEAD} L={len(ENC_SHAPES)} P={N_POINTS}",
        **err,
        "ms": device_ms(kernel, 50),
        "ms_launched_from_python": cuda_ms(kernel, 50),
        "plain_ms": cuda_ms(plain, 5),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "compulsory_bytes": nbytes, "flops": flops,
        "value_row_bytes": value_rows * row,
        "corner_row_bytes": sum(corners) * row,
        "corner_row_bytes_resident": sum(corners[lvl]
                                         for lvl in plan.resident) * row,
        "blocks": plan.n_runs * BATCH * M_HEADS, "runs": plan.n_runs,
        "longest_run": plan.max_run, "tiled_order": not plan.identity,
        "resident_levels": list(plan.resident),
        "resident_bytes": plan.resident_bytes,
        "grad_levels_in_shared": list(plan.grad),
        "grad_bytes": plan.grad_bytes,
    }
    res["corner_rate_TBps"] = rows_moved * res["corner_row_bytes"] \
        / res["ms"] / 1e9
    res["l2_corner_rate_TBps"] = rows_moved * (
        res["corner_row_bytes"] - res["corner_row_bytes_resident"]) \
        / res["ms"] / 1e9
    return res


def check_msda(rng, q: int, ref, label: str, dev, wide: bool = False) -> dict:
    import torch

    from monosowa_tpu_torch.ops import msda

    value, loc, aw = msda_inputs(rng, q, ref, dev, wide)
    out_k = msda.ms_deform_attn(value, ENC_SHAPES, loc, aw)
    out_p = msda.ms_deform_attn_plain(value, ENC_SHAPES, loc, aw)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    scale = float(out_p.abs().max())
    # float32 sums in another order: 1e-5 of the output's magnitude
    if not (torch.isfinite(out_k).all() and err <= 1e-5 * scale):
        raise AssertionError(f"msda_fwd {label}: max abs err {err} > "
                             f"1e-5 * {scale}")
    # loc and aw read once, out written once; one multiply-add per channel
    return msda_report(
        label, q, value, loc, {"max_abs_err": err, "max_abs_out": scale},
        lambda: msda.ms_deform_attn(value, ENC_SHAPES, loc, aw),
        lambda: msda.ms_deform_attn_plain(value, ENC_SHAPES, loc, aw),
        msda_bound(value, loc, loc.numel() + aw.numel() + out_k.numel(), 1),
        1)


def check_msda_bwd(rng, q: int, ref, label: str, dev, wide: bool = False
                   ) -> dict:
    """The backward kernel (dvalue, dloc, daw in one call) against the
    plain backward on the same inputs and a random incoming gradient."""
    import numpy as np
    import torch

    from monosowa_tpu_torch.ops import msda

    value, loc, aw = msda_inputs(rng, q, ref, dev, wide)
    dout = torch.from_numpy(rng.normal(
        size=(BATCH, q, M_HEADS * D_HEAD)).astype(np.float32)).to(dev)

    def plain():
        dloc, daw = msda.msda_grad_loc_aw_plain(value, ENC_SHAPES, loc, aw,
                                                dout)
        return (msda.msda_grad_value_plain(value.shape, ENC_SHAPES, loc, aw,
                                           dout), dloc, daw)

    got = msda._launch_bwd(value, ENC_SHAPES, loc, aw, dout)
    want = plain()
    torch.cuda.synchronize()
    errs = {}
    for name, g, w in zip(("dvalue", "dloc", "daw"), got, want):
        err, scale = float((g - w).abs().max()), float(w.abs().max())
        errs[name] = {"max_abs_err": err, "max_abs": scale}
        # float32 sums in another order (dvalue's atomics in a different
        # order in every run): 1e-5 of the output's magnitude
        if not (torch.isfinite(g).all() and err <= 1e-5 * scale):
            raise AssertionError(f"msda_bwd {label} {name}: max abs err "
                                 f"{err} > 1e-5 * {scale}")
    # loc, aw and dout read once; dvalue, dloc and daw written once; two
    # multiply-adds per channel and in-bounds corner (the dot for dloc and
    # daw, the scatter for dvalue)
    return msda_report(
        label, q, value, loc,
        {"max_abs_err": max(e["max_abs_err"] for e in errs.values()),
         "outputs": errs},
        lambda: msda._launch_bwd(value, ENC_SHAPES, loc, aw, dout), plain,
        msda_bound(value, loc, 2 * (loc.numel() + aw.numel()) + dout.numel()
                   + value.numel(), 2), 2)


def synthetic_car(rng, template, moving: bool, n_ground: int = 740):
    """One car's scan as the labeller's aggregation hands it to the fit: the
    template posed at a known pose with 0.02 m noise, plus ground points.
    A moving car's ground points lie mostly on the camera's side of it, so
    the median of its scan lies before its center, as the +1 m shift of
    the moving-car grid expects.  Returns (points (n, 3) float32, pose
    dict)."""
    import numpy as np

    theta = rng.uniform(0, 2 * np.pi)
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    pose = np.array([rng.uniform(-8, 8), 0.9, rng.uniform(8, 40)])
    car = template @ rot.T + pose + rng.normal(scale=0.02,
                                               size=template.shape)
    z_lo, z_hi = (-12, 2) if moving else (-8, 8)
    ground = np.stack([pose[0] + rng.uniform(-8, 8, n_ground),
                       np.full(n_ground, 1.66),
                       pose[2] + rng.uniform(z_lo, z_hi, n_ground)], 1)
    return (np.concatenate([car, ground]).astype(np.float32),
            {"x": pose[0], "z": pose[2], "theta": theta})


def tfl_inputs(rng, b: int, p: int, dev, t: int = TFL_T, s: int = TFL_S):
    """scan (B, S, 3), mask (B, S), posed templates (B, P, T, 3) as the fit
    makes them: per car a noisy posed template plus ground points, padded
    to S with a masked tail and a few masked points inside; P poses around
    the true one (all thetas of a P-step circle at P >= 360, else 5 thetas
    x P / 5 translations near the truth)."""
    import numpy as np
    import torch

    from monosowa_tpu_torch.sowa.fitting import _pose_template
    from monosowa_tpu_torch.sowa.templates import TemplateBank

    template = TemplateBank.default(num_points=t).points[0]
    scan = np.zeros((b, s, 3), np.float32)
    mask = np.zeros((b, s), bool)
    thetas = np.zeros((b, p), np.float32)
    trans = np.zeros((b, p, 3), np.float32)
    for i in range(b):
        pts, pose = synthetic_car(rng, template, False,
                                  n_ground=min(740, s - t))
        center = np.median(pts, axis=0)
        scan[i, :len(pts)] = pts - center
        mask[i, :len(pts)] = True
        mask[i, 7:len(pts):29] = False
        true_t = np.array([pose["x"], 0.9, pose["z"]]) - center
        if p >= 360:
            thetas[i] = np.linspace(0, 2 * np.pi, p, endpoint=False)
            trans[i] = true_t
        else:
            n_tr = p // 5
            thetas[i] = np.tile(pose["theta"] + 0.157 * np.arange(-2, 3),
                                n_tr)
            trans[i] = np.repeat(true_t + rng.normal(
                scale=0.1, size=(n_tr, 3)) * [1, 0, 1], 5, axis=0)
    scan_d, mask_d = torch.from_numpy(scan).to(dev), \
        torch.from_numpy(mask).to(dev)
    posed = _pose_template(torch.from_numpy(template).to(dev),
                           torch.from_numpy(thetas).to(dev)) \
        + torch.from_numpy(trans).to(dev)[:, :, None, :]
    return scan_d, mask_d, posed.contiguous()


def check_tfl(rng, b: int, p: int, label: str, dev, t: int = TFL_T,
              s: int = TFL_S) -> dict:
    """The coverage-count kernel against its plain version: counts of pairs
    under the same float32 squared distance, so the fractions are equal
    (the bar is 1e-6, a count of one is 1e-3)."""
    import torch

    from monosowa_tpu_torch.ops import tfl

    scan, mask, posed = tfl_inputs(rng, b, p, dev, t, s)

    def plain():
        return tfl._fractions(
            *tfl.binary_both_way_counts_plain(scan, mask, posed, TFL_RADIUS),
            mask, t)

    got = tfl.binary_both_way_counts(scan, mask, posed, TFL_RADIUS)
    want = plain()
    torch.cuda.synchronize()
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    if not (all(torch.isfinite(g).all() for g in got) and err <= 1e-6):
        raise AssertionError(f"tfl_counts {label}: max abs err {err} > 1e-6")
    if not (float(got[0].max()) > 0.5 and float(got[1].max()) > 0.3):
        raise AssertionError(f"tfl_counts {label}: the poses around the "
                             f"truth cover too little: {float(got[0].max())}"
                             f", {float(got[1].max())}")
    # templates, scan and mask read once, two (B, P) outputs written once;
    # per pair of a template point and a VALID scan point 8 float32
    # operations (3 subtractions, 3 products, 2 sums)
    nbytes = 4 * (posed.numel() + scan.numel() + 2 * b * p) + mask.numel()
    pairs = int(mask.sum().item()) * p * t
    flops = 8 * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return {
        "shape": f"{label}: B={b} P={p} T={t} S={s} "
                 f"valid={int(mask.sum().item()) / b:.0f}",
        "max_abs_err": err, "max_t_frac": float(got[0].max()),
        "max_s_frac": float(got[1].max()),
        "ms": cuda_ms(lambda: tfl.binary_both_way_counts(
            scan, mask, posed, TFL_RADIUS), 20),
        "plain_ms": cuda_ms(plain, 2, warmup=1),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "compulsory_bytes": nbytes, "pairs": pairs, "flops": flops,
    }


def fit_check(dev, n_cars: int = FIT_CARS, fit_cfg=None) -> dict:
    """``fit_cars_conv`` through the kernel on cars at known poses, the
    bars of the JAX package's tests/test_pipeline_e2e.py (x, z within
    0.35 m, yaw within 6 degrees modulo pi).  Even cars stand; odd cars
    move, with a trajectory angle 2 degrees off the truth."""
    import numpy as np
    import torch

    from monosowa_tpu_torch.ops import tfl
    from monosowa_tpu_torch.sowa import fitting
    from monosowa_tpu_torch.sowa.templates import TemplateBank

    rng = np.random.default_rng(2)
    cfg = fit_cfg or fitting.FitConfig()
    template = TemplateBank.default().points[0]
    t0 = time.perf_counter()
    spec, occ, memb = fitting.make_conv_kernels(template, cfg, dev)
    kernels_s = time.perf_counter() - t0
    pts = np.zeros((n_cars, TFL_S, 3), np.float32)
    mask = np.zeros((n_cars, TFL_S), bool)
    moving = np.arange(n_cars) % 2 == 1
    theta_est = np.zeros(n_cars, np.float32)
    truth = []
    for i in range(n_cars):
        p, pose = synthetic_car(rng, template, bool(moving[i]))
        pts[i, :len(p)], mask[i, :len(p)] = p, True
        theta_est[i] = pose["theta"] + np.deg2rad(2.0) if moving[i] else 0
        truth.append(pose)
    batch = fitting.CarBatch(pts, mask, moving, theta_est, moving.copy(),
                             np.ones(n_cars, bool))
    tmpl = torch.as_tensor(template, device=dev)
    fitting.fit_cars_conv(batch, tmpl, occ, memb, spec, cfg)     # warm-up
    torch.cuda.synchronize()
    before = tfl.launches
    t0 = time.perf_counter()
    res = fitting.fit_cars_conv(batch, tmpl, occ, memb, spec, cfg)
    torch.cuda.synchronize()
    fit_ms = (time.perf_counter() - t0) * 1e3
    launches = tfl.launches - before
    if launches != TFL_PER_FIT:
        raise AssertionError(f"fit_cars_conv launched tfl_counts {launches} "
                             f"times, not {TFL_PER_FIT}")
    x, z, theta = (getattr(res, k).cpu().numpy() for k in ("x", "z", "theta"))
    dx = np.abs(x - [t["x"] for t in truth])
    dz = np.abs(z - [t["z"] for t in truth])
    dth = np.abs((theta - [t["theta"] for t in truth] + np.pi)
                 % (2 * np.pi) - np.pi)
    dyaw = np.degrees(np.minimum(dth, np.abs(dth - np.pi)))
    if not (np.isfinite([x, z, theta]).all() and dx.max() < 0.35
            and dz.max() < 0.35 and dyaw.max() < 6.0):
        raise AssertionError(f"fit: |dx| {dx.tolist()} |dz| {dz.tolist()} "
                             f"yaw deg {dyaw.tolist()}")

    # the tie order the rescore relies on, on the card: argmin is the first
    # minimum, a stable sort lists equal values by index
    ties = torch.tensor([[3, 1, 2, 1, 5, 1, 2, 0, 0, 4.]], device=dev)
    first = int(ties.argmin(dim=1))
    lowest = torch.sort(ties, dim=1, stable=True).indices[0, :6].tolist()
    if first != 7 or lowest != [7, 8, 1, 3, 5, 2]:
        raise AssertionError(f"tie order on the card: argmin {first}, "
                             f"stable sort {lowest}")

    # the coarse grid's counts are whole numbers: the rounded cuDNN
    # correlations against the same correlations without cuDNN
    local = torch.as_tensor(pts, device=dev) - res.center[:, None]
    mask_d = torch.as_tensor(mask, device=dev)
    got = tfl.grid_pose_counts_conv(local, mask_d, occ, memb, spec)
    counts_yxz, memb_yxz = tfl._conv_fields(local, mask_d, spec)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        raw = (torch.nn.functional.conv2d(memb_yxz, occ),
               torch.nn.functional.conv2d(counts_yxz, memb))
    with torch.backends.cudnn.flags(enabled=False):
        want = (torch.nn.functional.conv2d(memb_yxz, occ),
                torch.nn.functional.conv2d(counts_yxz, memb))
    for name, g, w in zip(("count_t", "count_s"), got, want):
        if not (torch.equal(w, w.round()) and torch.equal(g, w)):
            raise AssertionError(
                f"coarse grid {name}: rounded cuDNN correlation differs "
                f"from the correlation without cuDNN by "
                f"{float((g - w).abs().max())}")
    return {"phase": "fit", "cars": n_cars, "standing": int((~moving).sum()),
            "moving": int(moving.sum()), "grid": [spec.n_dx, spec.n_dz,
                                                  spec.n_theta],
            "fine_thetas": cfg.n_theta_fine, "conv_kernels_s": kernels_s,
            "fit_ms": fit_ms, "tfl_launches_per_fit": launches,
            "max_abs_dx_m": float(dx.max()), "max_abs_dz_m": float(dz.max()),
            "max_yaw_err_deg_standing": float(dyaw[~moving].max()),
            "max_yaw_err_deg_moving": float(dyaw[moving].max()),
            "cudnn_conv_max_off_whole": max(
                float((r - r.round()).abs().max()) for r in raw),
            "conv_count_max": [float(w.max()) for w in want]}


def label(dev, n_frames: int = LABEL_FRAMES, window: int = LABEL_WINDOW,
          hw=None, cfg=None) -> dict:
    """One group of reference frames of the synthetic sequence through
    ``PseudoLabeler.label_frames`` (host candidates: points, masks and
    frame ids, no depth maps)."""
    import numpy as np
    import torch

    from monosowa_tpu_torch.kittiio import read_label_file
    from monosowa_tpu_torch.ops import tfl
    from monosowa_tpu_torch.sowa import fitting, pipeline, sample

    h, w = hw or (sample.H, sample.W)
    t0 = time.perf_counter()
    frames, scene_cars = sample.make_sequence(n_frames, window, h=h, w=w)
    scene_s = time.perf_counter() - t0
    # the configuration of the JAX package's tools/bench_pipeline.py
    cfg = cfg or pipeline.PipelineConfig(
        nscans_before=window, nscans_after=window, max_cars=16,
        max_points=TFL_S, min_standing_points=400,
        fit=fitting.FitConfig(fine_chunk=60))
    labeler = pipeline.PseudoLabeler(cfg)       # on the card: no device given
    if labeler.device.type != "cuda":
        raise AssertionError(f"the labeller is on {labeler.device}")

    # every fit_cars_conv call of the run: cars, device ms, kernel launches
    fits = []
    fit_cars_conv = pipeline.fit_cars_conv

    def timed_fit(batch, *args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        before = tfl.launches
        start.record()
        res = fit_cars_conv(batch, *args)
        end.record()
        fits.append({"cars": len(batch.points), "events": (start, end),
                     "tfl_launches": tfl.launches - before})
        return res

    with tempfile.TemporaryDirectory() as tmp:
        jobs = sample.make_jobs(frames, window, tmp, h=h, w=w)
        pipeline.fit_cars_conv = timed_fit
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            tfl.launches = 0
            t0 = time.perf_counter()
            n_written = labeler.label_frames(jobs)      # the main path
            torch.cuda.synchronize()
            label_s = time.perf_counter() - t0
            launches = tfl.launches
        finally:
            pipeline.fit_cars_conv = fit_cars_conv
        peak = torch.cuda.max_memory_allocated()
        stages = dict(labeler.stage_seconds)
        if n_written != n_frames:
            raise AssertionError(f"{n_written} frames written, not "
                                 f"{n_frames}")
        cars_per_frame, worst = [], 0.0
        for job in jobs:
            labels = read_label_file(job["out_path"])
            if labels.names != ["Car"] * len(labels):
                raise AssertionError(f"{job['out_path']}: {labels.names}")
            vals = np.concatenate([labels.box2d.ravel(), labels.hwl.ravel(),
                                   labels.pos.ravel(), labels.ry])
            if not np.isfinite(vals).all():
                raise AssertionError(f"{job['out_path']}: non-finite label")
            cars_per_frame.append(len(labels))
            # the scene's cars in this reference frame's camera coordinates
            ego_z = frames[job["frame_index"]]["ego_z"]
            scene_xz = np.array([[c["x"], c["z"] - ego_z]
                                 for c in scene_cars])
            for pos in labels.pos:
                worst = max(worst, float(np.hypot(
                    scene_xz[:, 0] - pos[0], scene_xz[:, 1] - pos[2]).min()))
        mtimes = [os.path.getmtime(j["out_path"]) for j in jobs]
        again = labeler.label_frames(jobs)              # skip-if-exists
        if again != 0 or mtimes != [os.path.getmtime(j["out_path"])
                                    for j in jobs]:
            raise AssertionError(f"a second label_frames wrote {again} "
                                 "frames")
    if sum(cars_per_frame) < n_frames:
        raise AssertionError(f"cars per frame {cars_per_frame}")
    if worst > 2.5:
        raise AssertionError(f"a written car lies {worst} m from every "
                             "scene car")
    for f in fits:
        if f["tfl_launches"] != TFL_PER_FIT:
            raise AssertionError(f"a fit_cars_conv call launched tfl_counts "
                                 f"{f['tfl_launches']} times")
        start, end = f.pop("events")
        f["device_ms"] = start.elapsed_time(end)
    # the window is the JAX bench's default; production aggregates +-30
    # frames (PipelineConfig's default), which multiplies the extraction
    return {"phase": "label", "frames": n_frames, "window": window,
            "production_window": pipeline.PipelineConfig().nscans_before,
            "image_hw": [h, w], "points_per_frame": len(frames[0]["points"]),
            "distinct_frames": n_frames + 2 * window,
            "scene_build_s": scene_s, "label_files": n_written,
            "cars_per_frame": cars_per_frame,
            "max_dist_to_scene_car_m": worst,
            "label_ms_per_frame": label_s * 1e3 / n_frames,
            "stage_seconds": stages,
            "host_share": (stages["extract"] + stages["track_aggregate"])
            / label_s,
            "fits": fits, "tfl_launches": launches,
            "peak_mem_GB": peak / 1e9}


def check_row_fetch(form: str, label: str, dev) -> dict:
    """One form of the row-fetch kernel against its plain version at one
    shape: a copy with an exact bf16 -> f32 conversion, so the difference
    must be 0.  Also timed: the one PyTorch call that computes the same
    function (``index_select``, a cast and a mask; used nowhere in the
    port)."""
    import torch

    from monosowa_tpu_torch.ops import row_fetch as rf
    from tools import bench_gather_micro_torch as bench

    n_rows = RF_ROWS[label]
    block, k_win = rf.window_params(form)
    idx_np, bank_np = bench.make_inputs(RF_BQ, RF_D, RF_T, n_rows)
    bank = torch.from_numpy(bank_np).to(dev).to(torch.bfloat16)
    idx = torch.from_numpy(idx_np).to(dev)

    def kernel():
        return rf.row_fetch(bank, idx, RF_BQ, form=form)

    def plain():
        return rf.row_fetch_plain(bank, idx, RF_BQ, block, k_win)

    keep = rf.in_window(idx, RF_T, RF_BQ, block, k_win)[:, None]
    safe = idx.clamp(0, RF_T - 1)

    def library():
        return torch.index_select(bank, 0, safe).float() * keep

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not (torch.isfinite(got).all() and err == 0.0
            and torch.equal(library(), want)):
        raise AssertionError(f"row_fetch {form} {label}: max abs err {err}")
    return {
        "shape": f"{label}, {form}: N={n_rows} T={RF_T} D={RF_D} bf16 "
                 f"bq={RF_BQ} block={block} k_win={k_win}",
        "form": form, "max_abs_err": err,
        "coverage": float(keep.float().mean()),
        # a few microseconds a call: timed inside a replayed CUDA graph, or
        # the host's launch rate would be what is measured
        "ms": device_ms(kernel, 50),
        "plain_ms": device_ms(plain, 5),
        "library_ms": device_ms(library, 20),
        "ms_launched_from_python": cuda_ms(kernel, 50),
        # idx and bank read once, out written once; nothing is computed
        "bound_ms": bench.bound_ms(n_rows, RF_T, RF_D, bank.element_size()),
        "bound_by": "bytes",
    }


def bench_row_fetch() -> dict:
    """The micro-benchmark through its own entry point, both forms at its
    default shape, each held against the tool's numpy oracle."""
    from monosowa_tpu_torch.ops import row_fetch as rf
    from tools import bench_gather_micro_torch as bench

    rf.launches = 0
    runs = [bench.run(form) for form in rf.FORMS]   # the main path
    launches = rf.launches
    for r in runs:
        if not (r["on_card"] and r["max_err"] == 0.0
                and r["coverage"] == 1.0):
            raise AssertionError(f"bench_gather_micro_torch: {r}")
    if launches < 2 * len(runs):
        raise AssertionError(f"the tool launched row_fetch {launches} times")
    return {"phase": "bench", "runs": runs, "row_fetch_launches": launches}


def detector_config(root: str, h: int, w: int, model=None) -> dict:
    """The shipped detector's config (configs/monodetr_kitti.yaml) as a
    dict, with the batch, the epochs and the score threshold of this run."""
    return {
        "random_seed": 444,
        "dataset": {"type": "KITTI", "root_dir": root, "batch_size": BATCH,
                    "resolution": [w, h], "writelist": ["Car"],
                    "random_flip": 0.5, "aug_crop": False,
                    "depth_scale": "normal", "use_canonical_module": True,
                    "canonical_focal_length": 500.0},
        "model": model or {
            "num_classes": 3, "num_feature_levels": 4, "num_depth_bins": 80,
            "depth_min": 1e-3, "depth_max": 60.0, "enc_layers": 3,
            "dec_layers": 3, "hidden_dim": 256, "dim_feedforward": 256,
            "dropout": 0.1, "nheads": 8, "num_queries": 50,
            "enc_n_points": 4, "dec_n_points": 4},
        "optimizer": {"type": "adamw", "lr": 2e-4, "weight_decay": 1e-4},
        "lr_scheduler": {"type": "step", "warmup": False, "decay_rate": 0.1,
                         "decay_list": [125, 165]},
        "trainer": {"max_epoch": 1, "save_frequency": 1,
                    "save_path": os.path.join(root, "outputs")},
        # 0, so that the random-init model's detections reach the files
        "tester": {"mode": "all", "threshold": 0.0, "topk": 50},
    }


def epoch(dev, n_train: int = EPOCH_TRAIN, n_val: int = EPOCH_VAL,
          hw=(IMG_H, IMG_W), model=None, msda_per_forward=MSDA_PER_FORWARD
          ) -> dict:
    """Train -> checkpoint -> test -> KITTI AP -> best checkpoint ->
    evaluate-only with resume, through ``tools/train_val_torch.py``
    ``run``."""
    import numpy as np

    from monosowa_tpu_torch.evalkitti import eval as kitti_eval
    from monosowa_tpu_torch.kittiio import read_label_file
    from monosowa_tpu_torch.ops import msda
    from monosowa_tpu_torch.train import checkpoint as ckpt_io
    from monosowa_tpu_torch.train import tester
    from monosowa_tpu_torch.train.sample import (SampleDataset,
                                                 write_sample_labels)
    from tools import train_val_torch

    h, w = hw
    quiet = lambda s: None                                   # noqa: E731

    def no_python_route(*args, **kwargs):
        raise AssertionError("the AP evaluation left the native library for "
                             "its python route")

    python_route = (kitti_eval.compute_statistics,
                    kitti_eval._torch_bev_inter)
    kitti_eval.compute_statistics = no_python_route
    kitti_eval._torch_bev_inter = no_python_route
    try:
        with tempfile.TemporaryDirectory() as tmp:
            cfg = detector_config(tmp, h, w, model)
            train_ds = SampleDataset(n_train, cfg["dataset"])
            val_ds = SampleDataset(n_val, cfg["dataset"], first_id=n_train)
            label_dir = os.path.join(tmp, "training", "label_2")
            write_sample_labels(label_dir, val_ds)

            # the main path: one epoch, its checkpoint, its evaluation
            msda.launches = msda.bwd_launches = 0
            t0 = time.perf_counter()
            record = train_val_torch.run(cfg, train_ds, val_ds, dev,
                                         logger=quiet)
            run_s = time.perf_counter() - t0
            fwd_launches, bwd_launches = msda.launches, msda.bwd_launches

            steps = n_train // BATCH
            val_batches = -(-n_val // BATCH)
            ep, ev = record["epochs"][0], record["evaluated"][0]
            if record["device"] != str(dev) or len(record["epochs"]) != 1 \
                    or len(ep["loss_total"]) != steps \
                    or not np.isfinite(ep["loss_total"]).all() \
                    or not np.isfinite(list(ep["losses"].values())).all():
                raise AssertionError(f"epoch record: {record}")
            if bwd_launches != msda_per_forward * steps or \
                    fwd_launches != msda_per_forward * (steps + val_batches):
                raise AssertionError(
                    f"{steps} steps and {val_batches} test batches launched "
                    f"msda_fwd {fwd_launches} and msda_bwd {bwd_launches} "
                    "times")
            save_path = cfg["trainer"]["save_path"]
            ckpt = ckpt_io.latest_checkpoint(save_path)
            best = ckpt_io.latest_checkpoint(save_path, tag="best")
            if not (ckpt and ckpt.endswith("checkpoint_epoch_1") and best
                    and os.path.exists(ckpt + ".meta")
                    and os.path.exists(best + ".meta")):
                raise AssertionError(f"checkpoints: {os.listdir(save_path)}")
            saved = sorted(n for n in os.listdir(save_path) if n != "outputs")
            data_dir = os.path.join(save_path, "outputs", "data")

            def result_files():
                out = {}
                for name in sorted(os.listdir(data_dir)):
                    with open(os.path.join(data_dir, name), "rb") as f:
                        out[name] = f.read()
                return out

            files = result_files()
            rows = [len(read_label_file(os.path.join(data_dir, n)))
                    for n in files]
            if sorted(files) != [f"{i}.txt" for i in val_ds.idx_list] \
                    or min(rows) < 1:
                raise AssertionError(f"result files {sorted(files)}, rows "
                                     f"{rows}")
            res = ev["results"]
            aps = [a for k in AP_KEYS for a in res[k]["ap40"] + res[k]["ap11"]]
            if sorted(res) != sorted(AP_KEYS) or not all(
                    np.isfinite(a) and 0.0 <= a <= 100.0 for a in aps):
                raise AssertionError(f"AP dict: {res}")

            # evaluate-only, resumed from the checkpoint: the same files
            for name in files:
                os.remove(os.path.join(data_dir, name))
            t0 = time.perf_counter()
            again = train_val_torch.run(cfg, train_ds, val_ds, dev,
                                        evaluate_only=True, ckpt=ckpt,
                                        logger=quiet)
            eval_only_s = time.perf_counter() - t0
            if again["start_epoch"] != 1 or again["epochs"] \
                    or result_files() != files:
                raise AssertionError("evaluate-only from the checkpoint did "
                                     "not reproduce the result files")

            # the AP stack on its own ground truth: 100 (KITTI's AP needs
            # 41 valid boxes for that, hence a larger set of near cars)
            perfect_ds = SampleDataset(PERFECT_IMAGES, cfg["dataset"],
                                       first_id=100, max_depth=20.0)
            perfect_cfg = {"dataset": {"root_dir": os.path.join(tmp, "p")}}
            gt_dir = os.path.join(tmp, "p", "training", "label_2")
            write_sample_labels(gt_dir, perfect_ds)
            perfect = tester.evaluate_results(perfect_ds, gt_dir, perfect_cfg,
                                              quiet)
            if perfect["car_3d_strict"]["ap40"] != [100.0] * 3:
                raise AssertionError(f"ground truth as detections: {perfect}")
    finally:
        kitti_eval.compute_statistics, kitti_eval._torch_bev_inter = \
            python_route
    return {"phase": "epoch", "train_images": n_train, "val_images": n_val,
            "batch": BATCH, "image_hw": [h, w], "steps": steps,
            "run_s": run_s, "epoch_s": ep["train_s"],
            "steps_per_s": steps / ep["train_s"],
            "step_s": ep["step_s"], "loader_wait_s": ep["loader_wait_s"],
            "loss_total": ep["loss_total"],
            "checkpoint_ms": ep["checkpoint_s"] * 1e3,
            "checkpoint_files": saved,
            "test_ms_per_image": ev["inference"] * 1e3 / n_val,
            "ap_eval_ms": ev["ap"] * 1e3,
            "result_files": len(files), "result_rows": rows,
            "car_3d_strict_ap40": res["car_3d_strict"]["ap40"],
            "best_ap": record["best_ap"], "ap_route": "native",
            "evaluate_only_s": eval_only_s,
            "evaluate_only_files_identical": True,
            "ap_of_ground_truth": perfect["car_3d_strict"]["ap40"],
            "msda_fwd_launches": fwd_launches,
            "msda_bwd_launches": bwd_launches}


def sample_batch(rng, img_id0: int):
    """One request: BATCH normalised images with the KITTI-like P2 of the
    JAX package's `__graft_entry__._sample_batch` (f = 700, principal
    point at the centre)."""
    import numpy as np

    b, h, w = BATCH, IMG_H, IMG_W
    calib = np.tile(np.array([[700.0, 0, w / 2, 0], [0, 700.0, h / 2, 0],
                              [0, 0, 1, 0]], np.float32), (b, 1, 1))
    return {
        "image": rng.normal(size=(b, h, w, 3)).astype(np.float32),
        "calib": calib,
        "img_size": np.tile(np.array([w, h], np.float32), (b, 1)),
        "img_id": np.arange(img_id0, img_id0 + b, dtype=np.int64),
        "canonical_scale": np.ones(b, np.float32),
        "height_crop": np.ones(b, np.float32),
    }


def serve(dev) -> dict:
    import numpy as np
    import torch

    from monosowa_tpu_torch.kittiio import read_label_file
    from monosowa_tpu_torch.models.monodetr import MonoDETR
    from monosowa_tpu_torch.models.transformer import MSDeformAttnModule
    from monosowa_tpu_torch.ops import msda
    from monosowa_tpu_torch.train.tester import run_inference
    from monosowa_tpu_torch.train.trainer import MODEL_INPUTS, make_eval_step

    t0 = time.perf_counter()
    model = MonoDETR(device=dev, seed=0)
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    batches = [sample_batch(rng, 2 * i) for i in range(REQUESTS)]
    eval_step = make_eval_step(model, topk=50)
    eval_step(batches[0])                           # warm-up
    torch.cuda.synchronize()

    # the main path: three requests through run_inference
    with tempfile.TemporaryDirectory() as tmp:
        cfg = {"tester": {"threshold": 0.0, "topk": 50},
               "trainer": {"save_path": tmp}, "dataset": {}}
        msda.launches = 0
        t0 = time.perf_counter()
        out_dir = run_inference(model, batches, cfg, logger=lambda s: None)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches = msda.launches
        files = sorted(os.listdir(out_dir))
        n_rows = 0
        for f in files:
            labels = read_label_file(os.path.join(out_dir, f))
            vals = np.concatenate([labels.box2d.ravel(), labels.hwl.ravel(),
                                   labels.pos.ravel(), labels.ry,
                                   labels.score])
            if len(labels) != 50 or not np.isfinite(vals).all():
                raise AssertionError(f"{f}: {len(labels)} rows, finite "
                                     f"{np.isfinite(vals).all()}")
            n_rows += len(labels)
    if len(files) != REQUESTS * BATCH:
        raise AssertionError(f"{len(files)} result files")
    if launches != MSDA_PER_FORWARD * REQUESTS:
        raise AssertionError(f"msda_fwd launched {launches} times in "
                             f"{REQUESTS} forwards")

    # forward + top-k alone, per image
    def forward_all():
        for bt in batches:
            dets = eval_step(bt)
        return dets

    dets = forward_all()
    torch.cuda.synchronize()
    if not torch.isfinite(dets).all():
        raise AssertionError("non-finite detections")
    t0 = time.perf_counter()
    forward_all()
    torch.cuda.synchronize()
    fwd_ms_per_image = (time.perf_counter() - t0) * 1e3 / (REQUESTS * BATCH)

    # the same forward with the plain MSDA, called by name
    args = [torch.as_tensor(batches[0][k], device=dev) for k in MODEL_INPUTS]
    with torch.no_grad():
        out_k = model(*args)
        attn = [mod for mod in model.modules()
                if isinstance(mod, MSDeformAttnModule)]
        for mod in attn:
            mod.msda = msda.ms_deform_attn_plain
        out_p = model(*args)
        for mod in attn:
            mod.msda = msda.ms_deform_attn
    rel = {}
    for k in ("pred_boxes", "pred_logits", "pred_depth"):
        rel[k] = float((out_k[k] - out_p[k]).abs().max()
                       / out_p[k].abs().max())
    if max(rel.values()) > 1e-3:
        raise AssertionError(f"kernel forward vs plain forward: {rel}")
    return {"phase": "serve", "model_build_s": build_s,
            "requests": REQUESTS, "images_per_request": BATCH,
            "image_hw": [IMG_H, IMG_W], "result_files": len(files),
            "rows": n_rows, "msda_launches": launches,
            "serve_ms_per_image": serve_s * 1e3 / (REQUESTS * BATCH),
            "forward_ms_per_image": fwd_ms_per_image,
            "kernel_vs_plain_forward_max_rel": rel,
            "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9}


def train(dev) -> dict:
    import numpy as np
    import torch

    from monosowa_tpu_torch.models.criterion import CriterionConfig, criterion
    from monosowa_tpu_torch.models.layers import Dropout
    from monosowa_tpu_torch.models.monodetr import MonoDETR
    from monosowa_tpu_torch.models.transformer import MSDeformAttnModule
    from monosowa_tpu_torch.ops import msda
    from monosowa_tpu_torch.train.optim import make_optimizer
    from monosowa_tpu_torch.train.sample import sample_batch as train_batch
    from monosowa_tpu_torch.train.trainer import (MODEL_INPUTS,
                                                  make_train_step,
                                                  targets_from_batch)

    model = MonoDETR(device=dev, seed=0)
    batch = train_batch(BATCH, IMG_H, IMG_W)

    class KernelFwdPlainBwd(torch.autograd.Function):
        """The forward kernel with the plain backward, so that a whole-model
        comparison isolates the backward kernel."""

        @staticmethod
        def forward(ctx, value, loc, aw, shapes):
            ctx.shapes = shapes
            ctx.save_for_backward(value, loc, aw)
            return msda._launch_fwd(value, shapes, loc, aw)

        @staticmethod
        def backward(ctx, dout):
            value, loc, aw = ctx.saved_tensors
            dout = dout.contiguous()
            dloc, daw = msda.msda_grad_loc_aw_plain(value, ctx.shapes, loc,
                                                    aw, dout)
            return (msda.msda_grad_value_plain(value.shape, ctx.shapes, loc,
                                               aw, dout), dloc, daw, None)

    def kernel_fwd_plain_bwd(value, shapes, loc, aw):
        return KernelFwdPlainBwd.apply(value.contiguous(), loc.contiguous(),
                                       aw.contiguous(), tuple(shapes))

    # one forward + backward each from the seeded weights, in training mode
    # with dropout off: with the kernels, through the plain MSDA (autograd
    # through its gathers), and with the forward kernel and the plain
    # backward.  Before any update, so that every run compares at the same
    # weights: the backward's atomics round dvalue differently in every
    # run, and after a few updates the weights, and with them which
    # sampling points lie within rounding of a pixel edge, differ from run
    # to run
    model.train()
    dropouts = [mod for mod in model.modules() if isinstance(mod, Dropout)]
    dropout_p = [mod.p for mod in dropouts]
    for mod in dropouts:
        mod.p = 0.0
    attn = [mod for mod in model.modules()
            if isinstance(mod, MSDeformAttnModule)]
    inputs = [torch.as_tensor(batch[k], dtype=torch.float32, device=dev)
              for k in MODEL_INPUTS]
    targets = targets_from_batch(batch, dev)
    ccfg = CriterionConfig(group_num=model.group_num,
                           num_queries=model.num_queries,
                           num_classes=model.num_classes)

    def grads_with(fn):
        for mod in attn:
            mod.msda = fn
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses = criterion(model(*inputs), targets, ccfg)
        losses["loss_total"].backward()
        torch.cuda.synchronize()
        return ({k: float(v.detach()) for k, v in losses.items()},
                {n: p.grad.detach().clone()
                 for n, p in model.named_parameters()},
                torch.cuda.max_memory_allocated())

    losses_k, grads_k, peak_k = grads_with(msda.ms_deform_attn)
    losses_p, grads_p, peak_p = grads_with(msda.ms_deform_attn_plain)
    losses_kp, grads_kp, _ = grads_with(kernel_fwd_plain_bwd)
    for mod in attn:
        mod.msda = msda.ms_deform_attn
    for mod, p_drop in zip(dropouts, dropout_p):
        mod.p = p_drop
    model.zero_grad(set_to_none=True)
    loss_rel = {k: abs(losses_k[k] - v) / max(abs(v), 1e-12)
                for k, v in losses_p.items()}
    if max(loss_rel.values()) > 1e-5:
        raise AssertionError(f"kernel vs plain loss dict: {loss_rel}")
    if losses_kp != losses_k:
        raise AssertionError("the forward kernel is not deterministic: "
                             f"{losses_k} != {losses_kp}")
    # each tensor's max abs, floored at 1e-4 of the largest gradient: the
    # key projections' biases have an exact gradient of 0
    floor = 1e-4 * max(float(g.abs().max()) for g in grads_p.values())

    def grad_rel(want):
        rel = {n: float((grads_k[n] - g).abs().max())
               / max(float(g.abs().max()), floor) for n, g in want.items()}
        worst = max(rel, key=rel.get)
        return worst, rel[worst]

    # the backward kernel vs the plain backward, the same forward: 1e-3
    worst_b, rel_b = grad_rel(grads_kp)
    if rel_b > 1e-3:
        raise AssertionError(f"backward kernel vs plain backward, gradient "
                             f"of {worst_b}: {rel_b} of its scale")
    # both kernels vs the plain MSDA: the forwards differ in the last bits,
    # so from the second MSDA layer of each stack on, a sampling point
    # within rounding of a pixel edge can fall into the neighbouring cell,
    # where the bilinear weights' derivative (dLoc) jumps; 1e-2
    worst_a, rel_a = grad_rel(grads_p)
    if rel_a > 1e-2:
        raise AssertionError(f"kernels vs plain MSDA, gradient of "
                             f"{worst_a}: {rel_a} of its scale")
    del grads_k, grads_p, grads_kp
    torch.cuda.empty_cache()

    step = make_train_step(model, None, make_optimizer(model, 2e-4, 1e-4))
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    step(batch, gen)                                 # warm-up
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    # the main path: TRAIN_STEPS steps of make_train_step
    torch.cuda.reset_peak_memory_stats()
    msda.launches = msda.bwd_launches = 0
    history, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        history.append(step(batch, gen))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    fwd_launches, bwd_launches = msda.launches, msda.bwd_launches
    step_peak = torch.cuda.max_memory_allocated()
    for losses in history:
        if not all(np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"non-finite losses: {losses}")
        if not losses["grad_norm"] > 0:
            raise AssertionError(f"grad_norm {losses['grad_norm']}")
    if fwd_launches != bwd_launches or \
            fwd_launches != MSDA_PER_FORWARD * TRAIN_STEPS:
        raise AssertionError(f"{TRAIN_STEPS} train steps launched msda_fwd "
                             f"{fwd_launches} and msda_bwd {bwd_launches} "
                             "times")

    return {"phase": "train", "batch": BATCH, "image_hw": [IMG_H, IMG_W],
            "queries": TRAIN_QUERIES, "steps": TRAIN_STEPS,
            "warmup_step_s": warmup_s, "train_step_ms": step_ms,
            "train_step_ms_mean": sum(step_ms) / len(step_ms),
            "loss_total": [h["loss_total"] for h in history],
            "grad_norm": [h["grad_norm"] for h in history],
            "msda_fwd_launches": fwd_launches,
            "msda_bwd_launches": bwd_launches,
            "peak_mem_GB": step_peak / 1e9,
            "kernel_vs_plain_loss_max_rel": max(loss_rel.values()),
            "kernel_vs_plain_grad_max_rel": rel_a,
            "kernel_vs_plain_grad_worst": worst_a,
            "bwd_kernel_vs_plain_bwd_grad_max_rel": rel_b,
            "bwd_kernel_vs_plain_bwd_grad_worst": worst_b,
            "kernel_step_peak_mem_GB": peak_k / 1e9,
            "plain_step_peak_mem_GB": peak_p / 1e9}


def main() -> int:
    # one card: the first of those visible
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ("0" if visible is None
                                          else visible.split(",")[0])
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from monosowa_tpu_torch.evalkitti import native
    from monosowa_tpu_torch.models.transformer import encoder_reference_points
    from monosowa_tpu_torch.ops import _build

    # 1. env
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    emit({"phase": "env", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32": False})

    # 2. build: one compiler per source, all started together (nvcc for
    # the kernels, the host compiler for the KITTI evaluation's library)
    def timed_eval_build():
        t_eval = time.perf_counter()
        native.build()
        return time.perf_counter() - t_eval

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS) + 1) as pool:
        eval_build = pool.submit(timed_eval_build)
        logs = dict(zip(KERNELS, pool.map(_build.build, KERNELS)))
        eval_build_s = eval_build.result()
    registers = {k: ptxas_registers(log) for k, log in logs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "evalkitti_library_seconds": eval_build_s,
          "registers": registers})

    # 3. kernel vs plain at the serve and train paths' shapes
    rng = np.random.default_rng(0)
    s = sum(h * w for h, w in ENC_SHAPES)
    enc_ref = np.broadcast_to(encoder_reference_points(ENC_SHAPES)[None],
                              (BATCH, s, len(ENC_SHAPES), 2))

    def dec_ref(q):
        return np.broadcast_to(rng.uniform(0.05, 0.95, (BATCH, q, 1, 2)),
                               (BATCH, q, len(ENC_SHAPES), 2))

    def msda_cases(check):
        return {"encoder": check(rng, s, enc_ref, "encoder", dev),
                "encoder wide": check(rng, s, enc_ref, "encoder wide", dev,
                                      wide=True),
                "decoder": check(rng, 50, dec_ref(50), "decoder", dev),
                "train decoder": check(rng, TRAIN_QUERIES,
                                       dec_ref(TRAIN_QUERIES),
                                       "train decoder", dev)}

    fwd = msda_cases(check_msda)
    for res in fwd.values():
        emit({"phase": "kernel", "name": "msda_fwd",
              "registers": registers["msda_fwd"], **res})
    bwd = msda_cases(check_msda_bwd)
    for res in bwd.values():
        emit({"phase": "kernel", "name": "msda_bwd",
              "registers": registers["msda_bwd"], **res})
    cov = {"rescore": check_tfl(rng, 48, 40, "rescore", dev),
           "fine": check_tfl(rng, 4, 360, "fine pass", dev)}
    for res in cov.values():
        emit({"phase": "kernel", "name": "tfl_counts", **res})
    fetch = {f"{label} {form}": check_row_fetch(form, label, dev)
             for label in RF_ROWS for form in ("direct", "staged")}
    for res in fetch.values():
        emit({"phase": "kernel", "name": "row_fetch", **res})
    # hand the plain versions' large temporaries back, so the phases below
    # start from an empty allocator cache
    torch.cuda.empty_cache()

    # 4. serve
    srv = serve(dev)
    emit(srv)

    # 5. train
    trn = train(dev)
    emit(trn)

    # 6. fit
    emit(fit_check(dev))

    # 7. label
    lbl = label(dev)
    emit(lbl)

    # 8. bench
    bch = bench_row_fetch()
    emit(bch)

    # 9. epoch
    epc = epoch(dev)
    emit(epc)

    # 10. kernels; library_ms is None where no one PyTorch call computes the
    # kernel's function (MSDA, its gradient, the two-way coverage)
    def entry(name, source, replaces, launches, runs, first="encoder"):
        keys = ("shape", "max_abs_err", "ms", "ms_launched_from_python",
                "plain_ms", "bound_ms", "bound_by", "library_ms")
        enc = runs[first]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(launches.values()),
                "launches_by_path": launches,
                "max_abs_err": enc["max_abs_err"], "ms": enc["ms"],
                "plain_ms": enc["plain_ms"], "bound_ms": enc["bound_ms"],
                "bound_by": enc["bound_by"],
                "library_ms": enc.get("library_ms"),
                "ms_launched_from_python": enc.get("ms_launched_from_python"),
                "at": enc["shape"],
                "other_shapes": [{k: r.get(k) for k in keys}
                                 for key, r in runs.items() if key != first]}

    emit({"kernels": [
        entry("msda_fwd", "monosowa_tpu_torch/ops/csrc/msda_fwd.cu",
              "monosowa_tpu/ops/msda_mxu.py:378 (K1 ms_deform_attn_mxu); "
              "monosowa_tpu/ops/msda_pallas.py:71 (K4 "
              "ms_deform_attn_pallas)",
              {"serve": srv["msda_launches"],
               "train": trn["msda_fwd_launches"],
               "epoch": epc["msda_fwd_launches"]}, fwd),
        entry("msda_bwd", "monosowa_tpu_torch/ops/csrc/msda_bwd.cu",
              "monosowa_tpu/ops/msda_mxu.py:306 (K2 msda_gdot_mxu); "
              "monosowa_tpu/ops/msda_mxu.py:544 (K3 msda_dvalue_mxu)",
              {"train": trn["msda_bwd_launches"],
               "epoch": epc["msda_bwd_launches"]}, bwd),
        entry("tfl_counts", "monosowa_tpu_torch/ops/csrc/tfl_counts.cu",
              "monosowa_tpu/ops/tfl_pallas.py:67 (K5 "
              "binary_both_way_counts_pallas)",
              {"label": lbl["tfl_launches"]}, cov, "rescore"),
        entry("row_fetch", "monosowa_tpu_torch/ops/csrc/row_fetch.cu",
              "tools/bench_gather_micro.py:61 (K6 run; bodies _kernel_gather "
              ":26, _kernel_onehot :45)",
              {"bench": bch["row_fetch_launches"]}, fetch, "K6 direct"),
    ]})
    if torch.cuda.device_count() != 1:
        raise AssertionError(f"{torch.cuda.device_count()} cards visible")
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
