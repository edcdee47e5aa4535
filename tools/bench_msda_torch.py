#!/usr/bin/env python
"""Times the MSDA kernels of the torch port on one CUDA device, at the
shapes of the detector's paths: the encoder (B=2, Q=S=10,200 at the
384x1280 pyramid, 8 heads of 32 channels, 4 levels x 4 points) with offsets
near the reference points and with wide offsets (a standard deviation of 4
pixels of each level), and the decoder at serving (Q=50), in training
(Q=550) and under DN-DETR (Q=800), with a float32 value, the same value
rounded to bfloat16 (the kernels' bf16 forms, which the shipped model runs
on the card), or both.

For each shape and kernel it prints one JSON line: the kernel's time inside a
replayed CUDA graph (``ms``), the time of calls enqueued back to back from
Python (``ms_launched_from_python``: the device's time or the host's launch
rate, whichever is slower) and the largest error against the plain version.
It uses only ``ms_deform_attn``, ``_launch_bwd`` and the plain versions, so
it also times an older checkout of the port: copy this file, ``chip_smoke.py``
and ``monosowa_tpu_torch/timing.py`` into that checkout and run it there, on
the same machine one after the other, to compare two versions of the
kernels.

Usage: python tools/bench_msda_torch.py [--reps 50] [--rounds 2]
                                        [--dtype float32|bf16|both]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

DN_QUERIES = 800    # DN-DETR's decoder: 5 groups of 50 slots + 550 queries


def msda_cases(dev, dtypes, seed: int = 0) -> dict:
    """{(shape label, dtype name): (value, loc, aw, dout)} at the five
    shapes, value in each of ``dtypes`` (the same numbers rounded), made
    from ``seed``."""
    import torch

    import chip_smoke as cs
    from monosowa_tpu_torch.models.transformer import encoder_reference_points

    shapes = cs.ENC_SHAPES
    s = sum(h * w for h, w in shapes)
    rng = np.random.default_rng(seed)
    enc_ref = np.broadcast_to(encoder_reference_points(shapes)[None],
                              (cs.BATCH, s, len(shapes), 2))
    cases = {}
    for label, q, wide in (("encoder", s, False), ("encoder wide", s, True),
                           ("decoder", 50, False),
                           ("train decoder", cs.TRAIN_QUERIES, False),
                           ("DN decoder", DN_QUERIES, False)):
        ref = enc_ref if q == s else np.broadcast_to(
            rng.uniform(0.05, 0.95, (cs.BATCH, q, 1, 2)),
            (cs.BATCH, q, len(shapes), 2))
        value, loc, aw = cs.msda_inputs(rng, q, ref, dev, wide=wide)
        dout = torch.from_numpy(rng.normal(size=(
            cs.BATCH, q, cs.M_HEADS * cs.D_HEAD)).astype(np.float32)).to(dev)
        for dtype in dtypes:
            cases[label, str(dtype).replace("torch.", "")] = (
                value.to(dtype), loc, aw, dout)
    return cases


def main(argv=None) -> int:
    p = argparse.ArgumentParser("MSDA kernel times (torch / CUDA)")
    p.add_argument("--reps", type=int, default=50)
    p.add_argument("--rounds", type=int, default=2,
                   help="times every shape is measured, in turns")
    p.add_argument("--dtype", choices=("float32", "bf16", "both"),
                   default="float32", help="value's type")
    a = p.parse_args(argv)
    import torch

    import chip_smoke as cs
    from monosowa_tpu_torch.ops import msda
    from monosowa_tpu_torch.timing import device_ms, launched_ms

    if not torch.cuda.is_available():
        print("bench_msda_torch: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    shapes = cs.ENC_SHAPES
    dtypes = {"float32": (torch.float32,), "bf16": (torch.bfloat16,),
              "both": (torch.float32, torch.bfloat16)}[a.dtype]
    cases = msda_cases(dev, dtypes)

    def fwd(value, loc, aw, dout):
        return (msda.ms_deform_attn(value, shapes, loc, aw),)

    def fwd_plain(value, loc, aw, dout):
        return (msda.ms_deform_attn_plain(value, shapes, loc, aw),)

    def bwd(value, loc, aw, dout):
        return msda._launch_bwd(value, shapes, loc, aw, dout)

    def bwd_plain(value, loc, aw, dout):
        dloc, daw = msda.msda_grad_loc_aw_plain(value, shapes, loc, aw, dout)
        return (msda.msda_grad_value_plain(value.shape, shapes, loc, aw,
                                           dout, value.dtype), dloc, daw)

    for rnd in range(a.rounds):
        for (label, dtype), args in cases.items():
            for name, kernel, plain in (("msda_fwd", fwd, fwd_plain),
                                        ("msda_bwd", bwd, bwd_plain)):
                err = max(float((g.float() - w.float()).abs().max()
                                / w.float().abs().max())
                          for g, w in zip(kernel(*args), plain(*args)))
                print(json.dumps({
                    "name": name, "shape": label, "dtype": dtype,
                    "round": rnd,
                    "ms": device_ms(lambda: kernel(*args), a.reps),
                    "ms_launched_from_python": launched_ms(
                        lambda: kernel(*args), a.reps),
                    "max_err_over_max_abs": err}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
