#!/usr/bin/env python
"""Repeats the bf16 "backward kernel alone" comparison of ``chip_smoke.py``
(phase ``train_add_bf16``) on one CUDA device and prints one JSON line per
mode with the spread of its statistic.

The model is the shipped detector under the bf16 policy, from the seeded
weights, dropout off, on the add-data batch with the live payload, as the
smoke builds it.  Each repeat runs two forward and backward passes: the
MSDA kernels, and the forward kernel with the plain backward.  Its
statistic is the smoke's: each parameter's max |difference| over its scale
(floored at ``BF16_GRAD_FLOOR`` of the largest gradient), the worst
parameter's value held against ``BF16_BWD_GRAD_BAR``.

Modes: ``default`` runs with PyTorch's default algorithms (the plain
backward's ``index_add_`` sums in a changing order); ``deterministic``
with ``torch.use_deterministic_algorithms(True)`` and cuDNN's deterministic
algorithms, as the smoke's comparisons run.  The modes take turns, repeat
by repeat.  A line holds the repeats, how many passed the bar, the largest
value, a histogram of the values (4 decimals) and the worst parameter of
each run past the bar; and, over the first ``--plain-repeats`` repeats,
the largest statistic between two steps with the plain backward (0: the
mode gives the plain side the same bits every run).

Run it from a checkout's root; it uses that checkout's ``chip_smoke.py`` and
package, so a copy in another checkout measures that one.

Usage: python tools/bf16_grad_spread_torch.py [--modes default,deterministic]
                                              [--repeats 1000] [--seconds 120]
                                              [--plain-repeats 5]
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--modes", default="default,deterministic")
    ap.add_argument("--repeats", type=int, default=1000)
    ap.add_argument("--seconds", type=float, default=120.0,
                    help="stop after the repeat that passes this time")
    ap.add_argument("--plain-repeats", type=int, default=5)
    args = ap.parse_args()
    modes = args.modes.split(",")
    if not set(modes) <= {"default", "deterministic"}:
        ap.error(f"modes: {modes}")

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("bf16_grad_spread_torch: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from monosowa_tpu_torch.models.criterion import criterion
    from monosowa_tpu_torch.models.layers import Dropout
    from monosowa_tpu_torch.models.monodetr import MonoDETR
    from monosowa_tpu_torch.models.transformer import MSDeformAttnModule
    from monosowa_tpu_torch.ops import msda
    from monosowa_tpu_torch.train.trainer import (MODEL_INPUTS,
                                                  _tfl_templates,
                                                  add_data_from_batch,
                                                  targets_from_batch)

    dev = torch.device("cuda", 0)
    model = MonoDETR(device=dev, seed=0, compute_dtype="bfloat16")
    ccfg = cs.add_data_ccfg(model)
    batch, _ = cs.add_data_batch()
    inputs = [torch.as_tensor(batch[k], dtype=torch.float32, device=dev)
              for k in MODEL_INPUTS]
    targets = targets_from_batch(batch, dev)
    add = add_data_from_batch(batch, *_tfl_templates(dev), dev)
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.p = 0.0
    model.train()
    live = cs.live_add_data(model, inputs, targets, add, ccfg)
    attn = [mod for mod in model.modules()
            if isinstance(mod, MSDeformAttnModule)]

    class PlainBackward(torch.autograd.Function):
        """The MSDA forward kernel with the plain backward."""

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
                                               aw, dout, value.dtype),
                    dloc, daw, None)

    def plain_backward(value, shapes, loc, aw):
        return PlainBackward.apply(value.contiguous(), loc.contiguous(),
                                   aw.contiguous(), tuple(shapes))

    def grads_with(fn):
        for mod in attn:
            mod.msda = fn
        model.zero_grad(set_to_none=True)
        try:
            losses = criterion(model(*inputs), targets, ccfg, add_data=live)
            losses["loss_total"].backward()
            torch.cuda.synchronize()
        finally:
            for mod in attn:
                mod.msda = msda.ms_deform_attn
        return {n: p.grad.detach().clone()
                for n, p in model.named_parameters() if p.grad is not None}

    def worst(got, want):
        floor = cs.BF16_GRAD_FLOOR * max(float(g.abs().max())
                                         for g in want.values())
        rel = {n: float((got[n] - g).abs().max())
               / max(float(g.abs().max()), floor) for n, g in want.items()}
        name = max(rel, key=rel.get)
        return rel[name], name

    runs = {mode: [] for mode in modes}
    plain_runs = {mode: [] for mode in modes}
    t0 = time.perf_counter()
    for rep in range(args.repeats):
        for mode in modes:
            det = mode == "deterministic"
            torch.use_deterministic_algorithms(det, warn_only=True)
            torch.backends.cudnn.deterministic = det
            plain = grads_with(plain_backward)
            runs[mode].append(worst(grads_with(msda.ms_deform_attn), plain))
            if rep < args.plain_repeats:
                plain_runs[mode].append(
                    worst(grads_with(plain_backward), plain)[0])
        if time.perf_counter() - t0 > args.seconds:
            break
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False

    bar = cs.BF16_BWD_GRAD_BAR
    for mode, res in runs.items():
        vals = [v for v, _ in res]
        print(json.dumps({
            "mode": mode, "repeats": len(vals), "bar": bar,
            "over_bar": sum(v > bar for v in vals), "max": max(vals),
            "histogram": dict(sorted(collections.Counter(
                round(v, 4) for v in vals).items())),
            "over": [[v, n] for v, n in res if v > bar],
            "plain_repeats": len(plain_runs[mode]),
            "plain_vs_plain_max": max(plain_runs[mode], default=None)}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
