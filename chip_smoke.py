#!/usr/bin/env python3
"""Smoke run of the torch port (``monosowa_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. env    — TF32 off for matmuls and convolutions; the card's name and
            power limit as nvidia-smi reports them.
2. build  — nvcc builds every kernel of the serve and train paths from
            ``ops/csrc``, one nvcc per source, all started together.
3. kernel — each kernel against its plain PyTorch version at the paths'
            shapes (MSDA forward: the encoder's B=2, Q=S=10,200 tokens and
            the decoder's Q=50 at serving and Q=550 in training; MSDA
            backward: the encoder's and the training decoder's), with
            error, times and the least time the card could take.
4. serve  — the full-width MonoDETR (ResNet-50, d_model 256, 3+3 layers,
            seeded random weights) answers three requests of two 384x1280
            images through ``run_inference``; the result files are read
            back, each kernel's launch count is checked, and one forward
            with the plain MSDA is compared with the kernel's.
5. train  — the same model in training mode (50 x 11 Group-DETR queries,
            dropout 0.1) takes a warm-up step and three timed steps of
            ``make_train_step`` with AdamW on ``sample_batch(2, 384,
            1280)``; losses, gradient norm and launch counts are checked.
            Then, dropout off and from the same weights, one forward and
            backward with the kernels against one through the plain MSDA
            (loss dict, gradients) and one with the forward kernel and
            the plain backward (gradients: the backward kernel alone).
6. kernels — one line listing every ported kernel with its numbers.

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
KERNELS = ("msda_fwd", "msda_bwd")
TRAIN_STEPS = 3
TRAIN_QUERIES = 50 * 11       # num_queries x group_num


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def msda_inputs(rng, q: int, ref, dev):
    """value, loc, aw for MSDA at the 384x1280 pyramid.  loc sits at the
    reference points plus ring-pattern offsets of the sampling-offset
    bias, jittered; 2% of the samples are redrawn in [-0.15, 1.15] so
    out-of-bounds corners are covered."""
    import numpy as np
    import torch

    from monosowa_tpu_torch.models.transformer import ring_bias

    b, m, d, p, n_lv = BATCH, M_HEADS, D_HEAD, N_POINTS, len(ENC_SHAPES)
    s = sum(h * w for h, w in ENC_SHAPES)
    ring = ring_bias(m, n_lv, p).reshape(1, 1, m, n_lv, p, 2)
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
    Returns (bound_ms, bound_by, bytes, flops, corners, value_rows)."""
    import torch

    from monosowa_tpu_torch.ops.msda import _corner_geometry

    b, s, m, d = value.shape
    bi = torch.arange(b, device=loc.device).view(b, 1, 1, 1)
    mi = torch.arange(m, device=loc.device).view(1, 1, m, 1)
    keys, corners, start = [], 0, 0
    for lvl, (h, w) in enumerate(ENC_SHAPES):
        for flat, _, _, _, inb in _corner_geometry(loc[:, :, :, lvl], h, w):
            hit = inb > 0
            corners += int(hit.sum().item())
            keys.append(((bi * s + start + flat) * m + mi)[hit])
        start += h * w
    value_rows = int(torch.unique(torch.cat(keys)).numel())
    nbytes = 4 * (value_rows * d + other_elems)
    flops = 2 * macs_per_corner * d * corners
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    return (max(t_bytes, t_ops) * 1e3, bound_by, nbytes, flops, corners,
            value_rows)


def check_msda(rng, q: int, ref, label: str, dev) -> dict:
    import torch

    from monosowa_tpu_torch.ops import msda

    value, loc, aw = msda_inputs(rng, q, ref, dev)
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
    bound_ms, bound_by, nbytes, flops, corners, value_rows = msda_bound(
        value, loc, loc.numel() + aw.numel() + out_k.numel(), 1)
    res = {
        "shape": f"{label}: B={BATCH} Q={q} S={value.shape[1]} "
                 f"M={M_HEADS} D={D_HEAD} L={len(ENC_SHAPES)} P={N_POINTS}",
        "max_abs_err": err, "max_abs_out": scale,
        "ms": cuda_ms(lambda: msda.ms_deform_attn(value, ENC_SHAPES, loc, aw),
                      50),
        "plain_ms": cuda_ms(
            lambda: msda.ms_deform_attn_plain(value, ENC_SHAPES, loc, aw), 5),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "compulsory_bytes": nbytes, "flops": flops,
        "value_row_bytes": value_rows * D_HEAD * 4,
        "corner_row_bytes": corners * D_HEAD * 4,
    }
    res["l2_corner_rate_TBps"] = res["corner_row_bytes"] / res["ms"] / 1e9
    return res


def check_msda_bwd(rng, q: int, ref, label: str, dev) -> dict:
    """The backward kernel (dvalue, dloc, daw in one launch) against the
    plain backward on the same inputs and a random incoming gradient."""
    import numpy as np
    import torch

    from monosowa_tpu_torch.ops import msda

    value, loc, aw = msda_inputs(rng, q, ref, dev)
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
    bound_ms, bound_by, nbytes, flops, corners, value_rows = msda_bound(
        value, loc, 2 * (loc.numel() + aw.numel()) + dout.numel()
        + value.numel(), 2)
    res = {
        "shape": f"{label}: B={BATCH} Q={q} S={value.shape[1]} "
                 f"M={M_HEADS} D={D_HEAD} L={len(ENC_SHAPES)} P={N_POINTS}",
        "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
        "outputs": errs,
        "ms": cuda_ms(lambda: msda._launch_bwd(value, ENC_SHAPES, loc, aw,
                                               dout), 50),
        "plain_ms": cuda_ms(plain, 5),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "compulsory_bytes": nbytes, "flops": flops,
        "corner_row_bytes": corners * D_HEAD * 4,
    }
    # every in-bounds corner reads one value row and adds into one dvalue row
    res["l2_corner_rate_TBps"] = 2 * res["corner_row_bytes"] / res["ms"] / 1e9
    return res


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

    # one forward + backward each from the same weights, dropout off: with
    # the kernels, through the plain MSDA (autograd through its gathers),
    # and with the forward kernel and the plain backward
    for mod in model.modules():
        if isinstance(mod, Dropout):
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

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        logs = dict(zip(KERNELS, pool.map(_build.build, KERNELS)))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {k: [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for k, log in logs.items()}})

    # 3. kernel vs plain at the serve and train paths' shapes
    rng = np.random.default_rng(0)
    s = sum(h * w for h, w in ENC_SHAPES)
    enc_ref = np.broadcast_to(encoder_reference_points(ENC_SHAPES)[None],
                              (BATCH, s, len(ENC_SHAPES), 2))

    def dec_ref(q):
        return np.broadcast_to(rng.uniform(0.05, 0.95, (BATCH, q, 1, 2)),
                               (BATCH, q, len(ENC_SHAPES), 2))

    fwd = {"encoder": check_msda(rng, s, enc_ref, "encoder", dev),
           "decoder": check_msda(rng, 50, dec_ref(50), "decoder", dev),
           "train decoder": check_msda(rng, TRAIN_QUERIES,
                                       dec_ref(TRAIN_QUERIES),
                                       "train decoder", dev)}
    for res in fwd.values():
        emit({"phase": "kernel", "name": "msda_fwd", **res})
    bwd = {"encoder": check_msda_bwd(rng, s, enc_ref, "encoder", dev),
           "train decoder": check_msda_bwd(rng, TRAIN_QUERIES,
                                           dec_ref(TRAIN_QUERIES),
                                           "train decoder", dev)}
    for res in bwd.values():
        emit({"phase": "kernel", "name": "msda_bwd", **res})

    # 4. serve
    srv = serve(dev)
    emit(srv)

    # 5. train
    trn = train(dev)
    emit(trn)

    # 6. kernels
    def entry(name, source, replaces, launches, runs):
        enc = runs["encoder"]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(launches.values()),
                "launches_by_path": launches,
                "max_abs_err": enc["max_abs_err"], "ms": enc["ms"],
                "plain_ms": enc["plain_ms"], "bound_ms": enc["bound_ms"],
                "bound_by": enc["bound_by"], "library_ms": None,
                "at": enc["shape"],
                "decoder": [{k: r[k] for k in ("shape", "max_abs_err", "ms",
                                               "plain_ms", "bound_ms",
                                               "bound_by")}
                            for key, r in runs.items() if key != "encoder"]}

    emit({"kernels": [
        entry("msda_fwd", "monosowa_tpu_torch/ops/csrc/msda_fwd.cu",
              "monosowa_tpu/ops/msda_mxu.py:378 (K1 ms_deform_attn_mxu); "
              "monosowa_tpu/ops/msda_pallas.py:71 (K4 "
              "ms_deform_attn_pallas)",
              {"serve": srv["msda_launches"],
               "train": trn["msda_fwd_launches"]}, fwd),
        entry("msda_bwd", "monosowa_tpu_torch/ops/csrc/msda_bwd.cu",
              "monosowa_tpu/ops/msda_mxu.py:306 (K2 msda_gdot_mxu); "
              "monosowa_tpu/ops/msda_mxu.py:544 (K3 msda_dvalue_mxu)",
              {"train": trn["msda_bwd_launches"]}, bwd),
    ]})
    if torch.cuda.device_count() != 1:
        raise AssertionError(f"{torch.cuda.device_count()} cards visible")
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
