#!/usr/bin/env python
"""Sweeps the block map of the torch port's MSDA kernels on one CUDA device:
tile shape, tiles a run, and which levels are resident in shared memory (for
value, and for the backward's share of dvalue), at the encoder's shape with
near and with wide offsets.  It sets the constants of
``monosowa_tpu_torch/ops/msda.py`` (``TILE_H``, ``TILE_W``, ``RUN_TILES``,
``RESIDENT_BUDGET``, ``RESIDENT_MIN_READS``, ``GRAD_MIN_ADDS``) for one
measurement each and prints one JSON line per setting with both kernels'
times inside a replayed CUDA graph.  The first line is the shipped setting.

Usage: python tools/tune_msda_torch.py [--reps 20]
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

KNOBS = ("TILE_H", "TILE_W", "RUN_TILES", "RESIDENT_BUDGET",
         "RESIDENT_MIN_READS", "GRAD_MIN_ADDS")


def main(argv=None) -> int:
    p = argparse.ArgumentParser("MSDA block-map sweep (torch / CUDA)")
    p.add_argument("--reps", type=int, default=20)
    a = p.parse_args(argv)
    import torch

    import chip_smoke as cs
    from monosowa_tpu_torch.models.transformer import encoder_reference_points
    from monosowa_tpu_torch.ops import msda
    from monosowa_tpu_torch.timing import device_ms

    if not torch.cuda.is_available():
        print("tune_msda_torch: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    shapes = cs.ENC_SHAPES
    s = sum(h * w for h, w in shapes)
    ref = np.broadcast_to(encoder_reference_points(shapes)[None],
                          (cs.BATCH, s, len(shapes), 2))
    rng = np.random.default_rng(0)
    inputs = {wide: cs.msda_inputs(rng, s, ref, dev, wide=wide)
              for wide in (False, True)}
    dout = torch.from_numpy(rng.normal(size=(
        cs.BATCH, s, cs.M_HEADS * cs.D_HEAD)).astype(np.float32)).to(dev)
    shipped = {k: getattr(msda, k) for k in KNOBS}

    def measure(label, **knobs):
        for k, v in {**shipped, **knobs}.items():
            setattr(msda, k, v)
        msda.msda_plan.cache_clear()
        plan = msda.msda_plan(shapes, s, cs.N_POINTS, cs.D_HEAD, dev)
        res = {"setting": label, **knobs, "runs": plan.n_runs,
               "longest_run": plan.max_run,
               "resident_levels": list(plan.resident),
               "grad_levels_in_shared": list(plan.grad)}
        for wide, (value, loc, aw) in inputs.items():
            tag = "_wide" if wide else ""
            res["fwd_ms" + tag] = device_ms(
                lambda: msda.ms_deform_attn(value, shapes, loc, aw), a.reps)
            res["bwd_ms" + tag] = device_ms(
                lambda: msda._launch_bwd(value, shapes, loc, aw, dout),
                a.reps)
        print(json.dumps(res), flush=True)

    try:
        measure("shipped")
        for tile in ((8, 8), (4, 16), (8, 16), (16, 16), (1, 128)):
            for run_tiles in (1, 2, 4, 6, 12):
                measure("tile, run", TILE_H=tile[0], TILE_W=tile[1],
                        RUN_TILES=run_tiles)
        measure("nothing resident", RESIDENT_BUDGET=0)
        measure("levels 3 and 2 resident, short runs", RESIDENT_MIN_READS=1)
        measure("levels 3 and 2 resident, both summed in shared memory",
                RESIDENT_MIN_READS=1, GRAD_MIN_ADDS=1)
        measure("level 3 resident, dvalue by global atomics only",
                GRAD_MIN_ADDS=10 ** 9)
        measure("index order in place of tiles", TILE_H=1, TILE_W=10 ** 6,
                RUN_TILES=1)
    finally:
        for k, v in shipped.items():
            setattr(msda, k, v)
        msda.msda_plan.cache_clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
