#!/usr/bin/env python
"""Times the LAP kernels of the torch port (``monosowa_tpu_torch/ops/csrc/
lap.cu``, through ``ops/lap.py`` ``lap_jv`` and ``lap_auction``) on one CUDA
device, at the shapes the detector gives them:

* ``jv step``: a train step's match, 22 problems (2 images x 11 Group-DETR
  groups) of 50 queries x 50 padded targets, 3 of them valid;
* ``jv generator``: the smoke's 22 problems of 50 x 50 (``chip_smoke.py``
  ``lap_problems``, seed 8; n_valid 0..50, ties, a constant problem);
* ``jv encoder``: two_stage's encoder match, 2 images x 10,200 tokens x 50
  padded targets, 12 and 7 valid;
* ``auction step`` and ``auction generator``: ``lap_auction`` on the first
  two.

Costs are seeded normals at random scales, padding columns at the
matcher's 1e6.  Each checkout runs in a process of its own (it builds its
kernels at first use): with ``--parent DIR`` the parent and this checkout
are timed in turns, parent / this / this / parent for two rounds, on the
same card.  For each case and turn a JSON line gives the kernel's time
inside a replayed CUDA graph (``ms``), whether its assignments equal the
plain version's, and the launches of each JV form where the checkout
counts them.  The summary lines give, per case, the parent's and this
checkout's ms, the dependent steps (the longest problem's Dijkstra steps
or auction rounds, counted on the host by copies of the plain loops,
``chip_smoke.jv_steps`` / ``auction_rounds``), us a step, the bound (the
cost read, the counts read and the assignment written once, at 3.35
TB/s), the plain version's ms on the card and the scipy route's (the
costs to the host, a scipy solve a problem, the assignment back).  With
``--forms`` this checkout also times every JV form that can take a shape,
and with ``--levers`` the auction's levers of ``tools/csrc/lap_levers.cu``
(each held to the plain version too).  The first line is the card's name
and power limit.

Usage: python tools/bench_lap_torch.py [--parent DIR] [--reps 20]
                                       [--rounds 2] [--forms] [--levers]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.abspath(__file__)
ROOT = os.path.join(os.path.dirname(HERE), "..")
HBM_BYTES_PER_S = 3.35e12
PAD = 1e6


def cases() -> dict:
    """{label: (solver, cost (N, Q, M) float32, n_valid (N,) int64)} as
    numpy arrays, the same in every process."""
    import numpy as np

    def padded(rng, n, q, valid):
        cost = (rng.normal(size=(n, q, 50))
                * 10 ** rng.uniform(-2, 2, (n, 1, 1))).astype(np.float32)
        for k, m in enumerate(valid):
            cost[k, :, m:] = PAD
        return cost, np.asarray(valid, np.int64)

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import torch

    gen = [t.numpy() for t in cs.lap_problems(np.random.default_rng(8),
                                              torch.device("cpu"))]
    step = padded(np.random.default_rng(18), 22, 50, [3] * 22)
    enc = padded(np.random.default_rng(19), 2, 10200, [12, 7])
    return {"jv step": ("jv", *step), "jv generator": ("jv", *gen),
            "jv encoder": ("jv", *enc), "auction step": ("auction", *step),
            "auction generator": ("auction", *gen)}


LEVERS = ("block rounds only", "zero rounds in shared memory",
          "zero rounds in registers, rows strided",
          "zero rounds in registers, rows in blocks")


def lever_runs(root: str, cost, n_valid) -> list:
    """[(name, fn)] of the auction's levers (tools/csrc/lap_levers.cu) on
    one batch, launched as ``lap_auction`` launches its kernel."""
    import ctypes

    import torch

    from monosowa_tpu_torch.ops import _build, lap

    lib = _build.load_library("lap_levers", os.path.join(root, "tools",
                                                         "csrc"))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lap_lever_auction.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i,
                                      ll, p]
    n, q, mmax = cost.shape
    plan = lap.auction_plan(q, mmax)
    counts = n_valid.to(torch.int32).contiguous()

    def run(lever):
        eps = lap.auction_eps(cost).contiguous()
        out = torch.empty(n, q, dtype=torch.int64, device=cost.device)
        err = lib.lap_lever_auction(
            cost.data_ptr(), counts.data_ptr(), eps.data_ptr(),
            out.data_ptr(), n, q, mmax, lap.AUCTION_PHASES,
            lap.AUCTION_ROUNDS, plan.threads, plan.slots, lever,
            plan.smem_bytes, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"lever {lever}: CUDA error {err}")
        return out

    return [(f"lever {k}: {name}", lambda k=k: run(k))
            for k, name in enumerate(LEVERS)]


def launch_counts(lap) -> dict:
    """The checkout's LAP launch counters: the tracer's ``lap.*`` counters
    (``utils/timing.py``), or an older checkout's module counters of
    ``ops/lap.py``."""
    from monosowa_tpu_torch.utils import timing

    if hasattr(timing, "TRACER"):
        return {k: v for k, v in timing.TRACER.counters.items()
                if k.startswith("lap.")}
    return {k: v for k, v in vars(lap).items()
            if k.endswith("_launches") and isinstance(v, int)}


def worker(root: str, reps: int, forms: bool, levers: bool) -> None:
    """Time the checkout at ``root``: one JSON line a case (and a form or
    lever)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from monosowa_tpu_torch.ops import lap
    from monosowa_tpu_torch.timing import device_ms

    dev = torch.device("cuda", 0)
    for label, (solver, cost, n_valid) in cases().items():
        cost = torch.from_numpy(cost).to(dev)
        n_valid = torch.from_numpy(n_valid).to(dev)
        kernel, plain = ((lap.lap_jv, lap.solve_lap_jv) if solver == "jv"
                         else (lap.lap_auction, lap.solve_lap_auction))
        want = plain(cost, n_valid)
        runs = [("planned", lambda: kernel(cost, n_valid))]
        if forms and solver == "jv" and hasattr(lap, "jv_forms"):
            runs += [(form, lambda p=p: lap._launch_jv(cost, n_valid, p))
                     for form, p in lap.jv_forms(*cost.shape[1:]).items()]
        if levers and solver == "auction":
            runs += lever_runs(root, cost, n_valid)
        for form, fn in runs:
            counts = launch_counts(lap)
            got = fn()
            torch.cuda.synchronize()
            moved = {k: v - counts.get(k, 0)
                     for k, v in launch_counts(lap).items()
                     if v != counts.get(k, 0)}
            print(json.dumps({
                "tree": root, "case": label, "form": form,
                "equal_plain": bool((got == want).all()),
                "launches": moved, "ms": device_ms(fn, reps)}), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser("LAP kernel times (torch / CUDA)")
    p.add_argument("--parent", help="root of an older checkout, timed in "
                   "turns with this one")
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--forms", action="store_true",
                   help="also time every JV form of this checkout")
    p.add_argument("--levers", action="store_true",
                   help="also time the auction's levers of this checkout")
    p.add_argument("--worker", help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("bench_lap_torch: no CUDA device", file=sys.stderr)
        return 2
    if a.worker:
        worker(a.worker, a.reps, a.forms, a.levers)
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from monosowa_tpu_torch.ops import lap

    trees = [ROOT] if not a.parent else [a.parent, ROOT, ROOT, a.parent]
    times: dict = {}
    for _ in range(a.rounds):
        for tree in trees:
            out = subprocess.run(
                [sys.executable, HERE, "--worker", tree, "--reps",
                 str(a.reps)] + [f"--{k}" for k in ("forms", "levers")
                                 if getattr(a, k) and tree == ROOT],
                capture_output=True, text=True)
            if out.returncode:
                print(out.stdout + out.stderr, file=sys.stderr)
                return out.returncode
            for line in out.stdout.splitlines():
                rec = json.loads(line)
                rec["tree"] = "parent" if tree == a.parent else "this"
                print(json.dumps(rec), flush=True)
                if not rec["equal_plain"]:
                    print(f"bench_lap_torch: {rec} differs from the plain "
                          "version", file=sys.stderr)
                    return 1
                times.setdefault((rec["case"], rec["tree"], rec["form"]),
                                 []).append(rec["ms"])
    dev = torch.device("cuda", 0)
    threads = torch.get_num_threads()

    def warm_ms(fn, reps):
        fn()               # imports and the allocator's first blocks
        return cs.host_clock_ms(fn, reps)

    for label, (solver, cost, n_valid) in cases().items():
        torch.set_num_threads(1)
        try:
            count = cs.jv_steps if solver == "jv" else cs.auction_rounds
            steps = int(count(torch.from_numpy(cost),
                              torch.from_numpy(n_valid))[0].max())
        finally:
            torch.set_num_threads(threads)
        c = torch.from_numpy(cost).to(dev)
        nv = torch.from_numpy(n_valid).to(dev)
        plain = lap.solve_lap_jv if solver == "jv" else lap.solve_lap_auction
        new = times[label, "this", "planned"]
        n, q, mmax = cost.shape
        print(json.dumps({
            "summary": label, "shape": f"N={n} Q={q} M={mmax}",
            "n_valid": n_valid.tolist(),
            "plan": (lap.jv_plan(q, mmax) if solver == "jv"
                     else lap.auction_plan(q, mmax)).__dict__,
            "parent_ms": times.get((label, "parent", "planned")), "ms": new,
            "forms_ms": {f: t for (lb, tr, f), t in times.items()
                         if lb == label and tr == "this" and f != "planned"},
            "dependent_steps": steps,
            "us_a_step": min(new) * 1e3 / max(steps, 1),
            "bound_ms": (cost.nbytes + n * 4 + n * q * 8)
            / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "plain_ms": warm_ms(lambda: plain(c, nv), 1),
            "host_route_ms": warm_ms(lambda: lap.solve_lap_host(c, nv), 3)}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
