"""The controls of the correctness check, run on the card at a cell's own
size: the plain reference put in the program's place and computed in
TF32 (the nearest precision below the configurations' float32 with TF32
off), and the faults planted in the reference, each compared with the
float32 reference by the cell's own numbers.  Each traffic's driver holds
its cell's controls (``controls``).  The benchmark's runs never run this;
it prints one JSON line a seed.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
for p in (HERE, os.path.dirname(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)

import bench_harness as bh  # noqa: E402


def resolve(bench: bh.Bench, workload: str):
    """(cell, configuration, traffic, the driver's ``controls``) of
    ``workload``."""
    cell = bench.cell(workload)
    traffic = bench.traffic(cell["traffic"])
    return (cell, bench.config(cell["config"]), traffic,
            bench.driver(traffic).controls)


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--pending", type=int, choices=(0, 1), default=0,
                    help="1: also the cells held back in pending/")
    args = ap.parse_args(argv)
    bench = bh.Bench(pending=bool(args.pending))
    cell, config, traffic, controls = resolve(bench, args.workload)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda")
    for seed in args.seeds:
        res = controls(bench, cell, seed, dev, config, traffic)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "card": bh.power_limit(), **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
