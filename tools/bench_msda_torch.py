#!/usr/bin/env python
"""Times the MSDA kernels of the torch port on one CUDA device, at the
shapes of the detector's paths: the encoder (B=2, Q=S=10,200 at the
384x1280 pyramid, 8 heads of 32 channels, 4 levels x 4 points) with offsets
near the reference points and with wide offsets (a standard deviation of 4
pixels of each level), and the decoder at serving (Q=50) and in training
(Q=550).

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


def main(argv=None) -> int:
    p = argparse.ArgumentParser("MSDA kernel times (torch / CUDA)")
    p.add_argument("--reps", type=int, default=50)
    p.add_argument("--rounds", type=int, default=2,
                   help="times every shape is measured, in turns")
    a = p.parse_args(argv)
    import torch

    import chip_smoke as cs
    from monosowa_tpu_torch.models.transformer import encoder_reference_points
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
    s = sum(h * w for h, w in shapes)
    rng = np.random.default_rng(0)
    enc_ref = np.broadcast_to(encoder_reference_points(shapes)[None],
                              (cs.BATCH, s, len(shapes), 2))
    cases = {}
    for label, q, wide in (("encoder", s, False), ("encoder wide", s, True),
                           ("decoder", 50, False),
                           ("train decoder", cs.TRAIN_QUERIES, False)):
        ref = enc_ref if q == s else np.broadcast_to(
            rng.uniform(0.05, 0.95, (cs.BATCH, q, 1, 2)),
            (cs.BATCH, q, len(shapes), 2))
        value, loc, aw = cs.msda_inputs(rng, q, ref, dev, wide=wide)
        dout = torch.from_numpy(rng.normal(size=(
            cs.BATCH, q, cs.M_HEADS * cs.D_HEAD)).astype(np.float32)).to(dev)
        cases[label] = (value, loc, aw, dout)

    def fwd(value, loc, aw, dout):
        return (msda.ms_deform_attn(value, shapes, loc, aw),)

    def fwd_plain(value, loc, aw, dout):
        return (msda.ms_deform_attn_plain(value, shapes, loc, aw),)

    def bwd(value, loc, aw, dout):
        return msda._launch_bwd(value, shapes, loc, aw, dout)

    def bwd_plain(value, loc, aw, dout):
        dloc, daw = msda.msda_grad_loc_aw_plain(value, shapes, loc, aw, dout)
        return (msda.msda_grad_value_plain(value.shape, shapes, loc, aw,
                                           dout), dloc, daw)

    for rnd in range(a.rounds):
        for label, args in cases.items():
            for name, kernel, plain in (("msda_fwd", fwd, fwd_plain),
                                        ("msda_bwd", bwd, bwd_plain)):
                err = max(float((g - w).abs().max() / w.abs().max())
                          for g, w in zip(kernel(*args), plain(*args)))
                print(json.dumps({
                    "name": name, "shape": label, "round": rnd,
                    "ms": device_ms(lambda: kernel(*args), a.reps),
                    "ms_launched_from_python": launched_ms(
                        lambda: kernel(*args), a.reps),
                    "max_err_over_max_abs": err}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
