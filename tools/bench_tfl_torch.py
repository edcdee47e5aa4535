#!/usr/bin/env python
"""Times the template-fitting coverage kernel of the torch port
(``monosowa_tpu_torch/ops/csrc/tfl_counts.cu``, through
``ops/tfl.py`` ``binary_both_way_counts``) on one CUDA device, at the two
shapes the fit gives it: the rescore (48 cars x 40 poses) and the fine pass
(4 cars x 360 poses), 1000 template points against 2048 scan points, the
inputs of ``chip_smoke.py`` ``tfl_inputs`` (cars posed at known poses with
ground points, poses around the truth).

For each shape and round it prints one JSON line: the kernel's time inside
a replayed CUDA graph (``ms``: ``_launch_counts``, the launch without the
wrapper's divisions, which copy a host scalar and so cannot be captured),
the time of whole calls enqueued back to back from Python
(``ms_launched_from_python``), whether the counts equal the plain
version's and, where the checkout has the kernel's cell-list mirror
(``tfl.cell_walk``), the pairs the kernel tests (``cell_pairs``) beside all
pairs and the least time the card could take for them (``bound_ms``).  It
uses only ``binary_both_way_counts``, ``_launch_counts``, the plain version
and ``chip_smoke.tfl_inputs``, so it also times an older checkout: copy this
file into that checkout and run it there, on the same machine one after the
other, to compare two versions of the kernel.

Usage: python tools/bench_tfl_torch.py [--reps 20] [--rounds 2]
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

SHAPES = {"rescore": (48, 40), "fine pass": (4, 360)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser("TFL coverage kernel times (torch / CUDA)")
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--rounds", type=int, default=2,
                   help="times every shape is measured, in turns")
    a = p.parse_args(argv)
    import torch

    import chip_smoke as cs
    from monosowa_tpu_torch.ops import tfl
    from monosowa_tpu_torch.timing import device_ms, launched_ms

    if not torch.cuda.is_available():
        print("bench_tfl_torch: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    rng = np.random.default_rng(0)
    cases = {label: cs.tfl_inputs(rng, b, n_poses, dev)
             for label, (b, n_poses) in SHAPES.items()}
    work = {label: cs.tfl_work(*args) if hasattr(tfl, "cell_walk") else {}
            for label, args in cases.items()}
    for rnd in range(a.rounds):
        for label, (scan, mask, posed) in cases.items():
            def launch():
                return tfl._launch_counts(scan, mask, posed, cs.TFL_RADIUS)

            def call():
                return tfl.binary_both_way_counts(scan, mask, posed,
                                                  cs.TFL_RADIUS)

            want = tfl.binary_both_way_counts_plain(scan, mask, posed,
                                                    cs.TFL_RADIUS)
            equal = all(torch.equal(g, w) for g, w in zip(launch(), want))
            print(json.dumps({
                "name": "tfl_counts", "shape": label, "round": rnd,
                "ms": device_ms(launch, a.reps),
                "ms_launched_from_python": launched_ms(call, a.reps),
                "counts_equal_plain": equal, **work[label]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
