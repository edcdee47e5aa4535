#!/usr/bin/env python
"""Row-fetch micro-benchmark of the torch port: the row gathers that
multi-scale deformable attention makes, rows straight from global memory /
L2 (``direct``) against the window staged through shared memory
(``staged``), on one CUDA device.

Counterpart of the JAX package's ``tools/bench_gather_micro.py`` (its
``gather`` and ``onehot`` forms): the same arguments, the same seeded
indices, clustered per block of ``bq`` rows like the sampling points around
an anchor, and the same coverage oracle.  Prints the largest error against
the oracle, the share of rows inside their block's window, the kernel's ms
per call, the least time the device could take (idx, bank and out moved
once at the memory rate) and the ms of the one PyTorch call that computes
the same function (``index_select``, a cast and a mask).

Usage: python tools/bench_gather_micro_torch.py [direct|staged]
           [--bq 256] [--d4 128] [--t_total 10240] [--block B] [--k_win K]
           [--rows N] [--reps 16] [--f32] [--cpu]

``--rows`` fetches N rows from the same bank (default: ``t_total``, the JAX
tool's shape); ``--cpu`` runs the plain version and reports the host's time.
The last line is the result as one JSON object.  ``run`` uses only
``row_fetch``, ``window_params`` and ``timing.device_ms``, so it also times
an older checkout of the port: copy this file into that checkout and run it
there, on the same machine one after the other, to compare two versions of
the kernels.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, Optional

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np

from monosowa_tpu_torch.timing import device_ms  # noqa: E402

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory


def make_inputs(bq: int = 256, d4: int = 128, t_total: int = 10240,
                n_rows: Optional[int] = None, seed: int = 0):
    """(idx (N,) int32, bank (t_total, d4) float32) as numpy arrays: per
    block of ``bq`` rows a center and offsets below 500, the JAX tool's
    draws (equal to them when ``n_rows`` is ``t_total``)."""
    n_rows = t_total if n_rows is None else n_rows
    nb = -(-n_rows // bq)
    rng = np.random.default_rng(seed)
    centers = rng.integers(0, t_total - 600, nb)
    idx = (centers[:, None] + rng.integers(0, 500, (nb, bq))).astype(np.int32)
    idx = np.minimum(idx, t_total - 1).reshape(nb * bq)[:n_rows]
    bank = rng.standard_normal((t_total, d4)).astype(np.float32)
    return idx, bank


def oracle(idx: np.ndarray, bank_f32: np.ndarray, bq: int, block: int,
           k_win: int):
    """(want (N, D) float32, coverage (N,) bool) in numpy: the rows, zeroed
    where the index misses its block's window."""
    n, t_total = len(idx), len(bank_f32)
    nb = -(-n // bq)
    ii = np.full(nb * bq, -1, np.int64)
    ii[:n] = idx
    ii = ii.reshape(nb, bq)
    lo = np.where(ii < 0, 2 ** 30, ii).min(1)
    base_c = np.clip(lo // block, 0, max(t_total // block - k_win, 0))
    cov = ((ii >= (base_c[:, None] * block))
           & (ii < (base_c[:, None] + k_win) * block)
           & (ii < t_total)).reshape(-1)[:n]
    want = bank_f32[np.clip(idx, 0, t_total - 1)] * cov[:, None]
    return want.astype(np.float32), cov


def bound_ms(n_rows: int, t_total: int, d4: int, itemsize: int) -> float:
    """idx and bank read once, out written once, at the memory rate."""
    nbytes = n_rows * 4 + t_total * d4 * itemsize + n_rows * d4 * 4
    return nbytes / HBM_BYTES_PER_S * 1e3


def host_ms(fn, reps: int) -> float:
    """Mean host time of ``fn()`` in ms (the CPU route)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def run(form: str = "direct", bq: int = 256, d4: int = 128,
        t_total: int = 10240, block: Optional[int] = None,
        k_win: Optional[int] = None, reps: int = 16,
        n_rows: Optional[int] = None, f32: bool = False,
        device=None) -> Dict[str, Any]:
    """One form at one shape; prints the tool's lines and returns the
    numbers."""
    import torch

    from monosowa_tpu_torch import resolve_device
    from monosowa_tpu_torch.ops import row_fetch as rf

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    block, k_win = rf.window_params(form, block, k_win)
    idx_np, bank_np = make_inputs(bq, d4, t_total, n_rows)
    dtype = torch.float32 if f32 else torch.bfloat16
    bank = torch.from_numpy(bank_np).to(dev).to(dtype)
    idx = torch.from_numpy(idx_np).to(dev)

    def fetch():
        return rf.row_fetch(bank, idx, bq, block, k_win, form)

    out = fetch().cpu().numpy()
    want, cov = oracle(idx_np, bank.float().cpu().numpy(), bq, block, k_win)
    err = float(np.abs(out - want).max())
    where = str(dev) if not on_card else torch.cuda.get_device_name(dev)
    what = "kernel" if on_card else "plain version"
    print(f"{form}: max err {err}  coverage {cov.mean():.3f}  ({what} on "
          f"{where})")

    time_ms = device_ms if on_card else host_ms
    keep = torch.from_numpy(cov).to(dev)[:, None]
    safe = idx.clamp(0, t_total - 1)

    def library():
        return torch.index_select(bank, 0, safe).float() * keep

    res = {"form": form, "device": where, "on_card": on_card,
           "n_rows": len(idx_np), "t_total": t_total, "d4": d4, "bq": bq,
           "block": block, "k_win": k_win, "bank_dtype": str(dtype),
           "max_err": err, "coverage": float(cov.mean()),
           "ms": time_ms(fetch, reps), "library_ms": time_ms(library, reps),
           "bound_ms": bound_ms(len(idx_np), t_total, d4,
                                bank.element_size())}
    clock = "device time, a replayed CUDA graph" if on_card else "host time"
    print(f"{form}: {res['ms']:.4f} ms per call ({clock}; "
          f"N={res['n_rows']}, block={block}, k_win={k_win}); bound "
          f"{res['bound_ms']:.5f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s; "
          f"index_select + cast + mask {res['library_ms']:.4f} ms")
    return res


def main(argv=None) -> Dict[str, Any]:
    p = argparse.ArgumentParser("row-fetch micro-benchmark (torch / CUDA)")
    p.add_argument("form", nargs="?", default="direct",
                   choices=("direct", "staged"))
    p.add_argument("--bq", type=int, default=256)
    p.add_argument("--d4", type=int, default=128)
    p.add_argument("--t_total", type=int, default=10240)
    p.add_argument("--block", type=int, default=None)
    p.add_argument("--k_win", type=int, default=None)
    p.add_argument("--rows", type=int, default=None)
    p.add_argument("--reps", type=int, default=16)
    p.add_argument("--f32", action="store_true", help="a float32 bank")
    p.add_argument("--cpu", action="store_true",
                   help="run the plain version on the CPU")
    a = p.parse_args(argv)
    res = run(a.form, a.bq, a.d4, a.t_total, a.block, a.k_win, a.reps,
              a.rows, a.f32, "cpu" if a.cpu else None)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
