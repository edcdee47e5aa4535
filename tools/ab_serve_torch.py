#!/usr/bin/env python
"""The serve phases of two checkouts in turns, on one card in one call.

Each turn starts a process in a checkout's root that builds its MSDA
kernels and runs its own ``chip_smoke.py`` ``serve`` (float32) and
``serve(bf16=True)``: three 2-image 384 x 1280 requests through
``run_inference`` and the forward alone.  The turns go parent, new, new,
parent, and so on, so that both sides meet the same drift.  One JSON line
a turn; the last line, each side's medians and ranges.

Usage (on the card; the parent unpacked with ``git archive <commit>``
into a directory that .gitignore lists)::

    python3 tools/ab_serve_torch.py --parent build/parent [--new .] \
        [--pairs 3]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

CHILD = r"""
import json, os, sys
sys.path.insert(0, os.getcwd())
from concurrent.futures import ThreadPoolExecutor
import chip_smoke as cs
from monosowa_tpu_torch.device import resolve_device
from monosowa_tpu_torch.ops import _build
with ThreadPoolExecutor(3) as pool:
    list(pool.map(_build.build, ("msda_fwd", "msda_fwd_bf16", "msda_bwd")))
dev = resolve_device("cuda")
out = {}
for bf16 in (False, True):
    r = cs.serve(dev, bf16=bf16)
    out[r["phase"]] = {k: r[k] for k in ("forward_ms_per_image",
                                         "serve_ms_per_image")}
print(json.dumps(out))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--new", default=os.path.join(os.path.dirname(
        os.path.abspath(__file__)), ".."))
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args(argv)
    trees = {"parent": os.path.abspath(args.parent),
             "new": os.path.abspath(args.new)}
    order = [("parent", "new"), ("new", "parent")] * args.pairs
    runs = {"parent": [], "new": []}
    for pair in order[:args.pairs]:
        for name in pair:
            p = subprocess.run([sys.executable, "-c", CHILD],
                               cwd=trees[name], capture_output=True,
                               text=True)
            if p.returncode:
                raise SystemExit(f"{name}: {p.stderr[-2000:]}")
            res = json.loads(p.stdout.strip().splitlines()[-1])
            runs[name].append(res)
            print(json.dumps({"tree": name, **res}), flush=True)
    summary = {}
    for name, rs in runs.items():
        for phase in ("serve", "serve_bf16"):
            for key in ("forward_ms_per_image", "serve_ms_per_image"):
                vals = [r[phase][key] for r in rs]
                summary[f"{name} {phase} {key}"] = {
                    "median": statistics.median(vals),
                    "min": min(vals), "max": max(vals)}
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
