#!/usr/bin/env python
"""Sweeps the levers of the torch port's MSDA kernels on one CUDA device and
prints one JSON line per setting with the kernels' times inside a replayed
CUDA graph.  The first line of each sweep is the shipped setting.

``--dtype float32`` (the default): the block map at the encoder's shape
with near and with wide offsets: tile shape, tiles a run, and which levels
are resident in shared memory (for value, and for the backward's share of
dvalue), set through the constants of ``monosowa_tpu_torch/ops/msda.py``
(``TILE_H``, ``TILE_W``, ``RUN_TILES``, ``RESIDENT_BUDGET``,
``RESIDENT_MIN_READS``, ``GRAD_MIN_ADDS``).

``--dtype bf16``: the bf16 kernels at the five shapes of
``tools/bench_msda_torch.py`` (the encoder near and wide, the decoder at
Q = 50, 550 and 800).  First the constants of the bf16 forward's launch
(``FWD16_MAX_SPLIT``, ``SPLIT_FILL``, the block size ``FWD16_THREADS``,
at most the kernel's launch bound) and of the backward: the levels it sums
in the block (``SORT_MIN_ADDS``, ``SORT_SMEM_BUDGET``) and, without them,
its shared-memory levels.  Then the backward's levers of ``tools/csrc/msda_bwd_levers.cu``
at the encoder's shape, near and wide, in turns with the shipped kernel:
its walk rebuilt (dots and adds, as shipped), the dots alone, the adds
alone, the adds merged across a warp's queries by ``__match_any_sync``,
the dots and the adds in separate warps of a block, and the atomic-free
dvalue (a counting sort of the corners by row, one owner a row).  Every
lever that computes a whole output is held against the plain versions at
``chip_smoke.py``'s bars; ``ok`` says whether it held.  Last, the registers
and spills of the lever kernels and the atomic instructions in the shipped
backward's machine code (a shared-memory float add that is a
compare-and-swap loop shows as ``ATOMS.CAST.SPIN``).

``--duplicates`` (no card needed): by level, how many corner adds of the
encoder's inputs land on the same dvalue row among the four queries of a
warp and among a block's run: what merging the adds before L2 could save.

Usage: python tools/tune_msda_torch.py [--dtype float32|bf16] [--reps 20]
                                       [--rounds 2] [--duplicates]
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import glob
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

BF16_SETTINGS = (
    ("shipped", {}),
    ("forward: no split", {"FWD16_MAX_SPLIT": 1}),
    ("forward: split within a quarter of the card", {"SPLIT_FILL": 0.25}),
    ("forward: split within the whole card", {"SPLIT_FILL": 1.0}),
    ("forward: blocks of at most 256 threads", {"FWD16_THREADS": 256}),
    ("backward: no level summed in the block (the float32 form's walk)",
     {"SORT_MIN_ADDS": 10 ** 9}),
    ("backward: the walk, level 3 by global atomics only",
     {"SORT_MIN_ADDS": 10 ** 9, "GRAD_MIN_ADDS": 10 ** 9}),
    ("backward: the walk, levels 3 and 2 resident, both summed in shared "
     "memory", {"SORT_MIN_ADDS": 10 ** 9, "RESIDENT_MIN_READS": 1,
                "GRAD_MIN_ADDS": 1}),
    ("backward: level 3 alone summed in the block",
     {"SORT_MIN_ADDS": 1000}),
    ("backward: levels 1-3 summed in the block", {"SORT_MIN_ADDS": 64}),
    ("backward: every level summed in the block, one block an SM",
     {"SORT_MIN_ADDS": 1, "SORT_SMEM_BUDGET": 200 * 1024}),
)
LEVER_DIR = os.path.join(ROOT, "tools", "csrc")
# (label, threads a block, dot warps, role, merge, merge_mask, skip_mask,
# constants of ops/msda.py for the plan) of lever_bwd_bf16: role 0 dots and
# adds, 1 the dots alone, 2 the adds alone; merge 1 by __match_any_sync,
# 2 by pairs, on the levels of merge_mask; the adds of skip_mask's levels
# left out (dvalue then wrong)
SHARED_2_3 = {"RESIDENT_MIN_READS": 1, "GRAD_MIN_ADDS": 1}
LEVERS = (
    ("walk rebuilt: dots and adds", 1024, 0, 0, 0, 0, 0, {}),
    ("dots alone", 1024, 0, 1, 0, 0, 0, {}),
    ("adds alone", 1024, 0, 2, 0, 0, 0, {}),
    *((f"adds alone without level {lvl}'s", 1024, 0, 2, 0, 0, 1 << lvl, {})
      for lvl in range(4)),
    ("adds alone, merged by __match_any_sync on levels 0-2", 1024, 0, 2, 1,
     0b0111, 0, {}),
    *((f"adds alone, merged by pairs on levels {lo}-3", 1024, 0, 2, 2,
       0b1111 >> lo << lo, 0, {}) for lo in (3, 2, 1, 0)),
    ("dots and adds, merged by __match_any_sync on levels 0-2", 1024, 0, 0,
     1, 0b0111, 0, {}),
    *((f"dots and adds, merged by pairs on levels {lo}-3", 1024, 0, 0, 2,
       0b1111 >> lo << lo, 0, {}) for lo in (3, 2, 1, 0)),
    ("dots and adds, levels 2 and 3 summed in shared memory", 1024, 0, 0, 0,
     0, 0, SHARED_2_3),
    *((f"dots and adds, levels 2 and 3 summed in shared memory, merged by "
       f"pairs on levels {lo}-3", 1024, 0, 0, 2, 0b1111 >> lo << lo, 0,
       SHARED_2_3) for lo in (2, 1)),
    ("split: 4 dot warps, 12 add warps", 512, 4, 0, 0, 0, 0, {}),
    ("split: 4 dot warps, 12 add warps, merged by __match_any_sync", 512, 4,
     0, 1, 0b0111, 0, {}),
    ("split: 8 dot warps, 24 add warps", 1024, 8, 0, 0, 0, 0, {}),
    ("split: 8 dot warps, 24 add warps, merged by __match_any_sync", 1024,
     8, 0, 1, 0b0111, 0, {}),
    ("split: 12 dot warps, 20 add warps", 1024, 12, 0, 0, 0, 0, {}),
)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def tune_float32(a, dev) -> None:
    import chip_smoke as cs
    from monosowa_tpu_torch.models.transformer import encoder_reference_points
    from monosowa_tpu_torch.ops import msda
    from monosowa_tpu_torch.timing import device_ms

    shapes = cs.ENC_SHAPES
    s = sum(h * w for h, w in shapes)
    ref = np.broadcast_to(encoder_reference_points(shapes)[None],
                          (cs.BATCH, s, len(shapes), 2))
    rng = np.random.default_rng(0)
    inputs = {wide: cs.msda_inputs(rng, s, ref, dev, wide=wide)
              for wide in (False, True)}
    import torch

    dout = torch.from_numpy(rng.normal(size=(
        cs.BATCH, s, cs.M_HEADS * cs.D_HEAD)).astype(np.float32)).to(dev)

    def measure(label, **knobs):
        with constants(msda, knobs):
            plan = msda.msda_plan(shapes, s, cs.N_POINTS, cs.D_HEAD, dev)
            res = {"setting": label, **knobs, "runs": plan.n_runs,
                   "longest_run": plan.max_run,
                   "resident_levels": list(plan.resident),
                   "grad_levels_in_shared": list(plan.grad)}
            for wide, (value, loc, aw) in inputs.items():
                tag = "_wide" if wide else ""
                res["fwd_ms" + tag] = device_ms(
                    lambda: msda.ms_deform_attn(value, shapes, loc, aw),
                    a.reps)
                res["bwd_ms" + tag] = device_ms(
                    lambda: msda._launch_bwd(value, shapes, loc, aw, dout),
                    a.reps)
        print(json.dumps(res), flush=True)

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


class constants:
    """Sets constants of a module for a ``with`` block (the plan's cache
    cleared on the way in and out)."""

    def __init__(self, module, values: dict):
        self.module, self.values = module, values
        self.saved = {k: getattr(module, k) for k in values}

    def __enter__(self):
        for k, v in self.values.items():
            setattr(self.module, k, v)
        self.module.msda_plan.cache_clear()

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(self.module, k, v)
        self.module.msda_plan.cache_clear()


def duplicate_rows(loc: np.ndarray, shapes) -> dict:
    """For each level, the in-bounds corners of the encoder's queries and
    how many of them land on each distinct dvalue row, on average: among
    the four queries of a warp at one sample (``same_k``: the same corner
    k, which the merges by pairs and by ``__match_any_sync`` can join;
    ``any_k``: any corner), and among all the queries of a block's run
    (``block``).  Queries in the kernels' order, four to a warp."""
    from monosowa_tpu_torch.ops import msda

    b, q, m, _, p, _ = loc.shape
    order, runs = msda.query_order(shapes, q)
    run = np.repeat(np.arange(len(runs)), runs[:, 1])
    warp = run * q + np.concatenate([np.arange(n) for n in runs[:, 1]]) // 4
    ids = np.indices((b, q, m, p, 4))
    loc = loc[:, order]
    out = {}
    for lvl, (h, w) in enumerate(shapes):
        x = loc[:, :, :, lvl, :, 0] * np.float32(w) - np.float32(0.5)
        y = loc[:, :, :, lvl, :, 1] * np.float32(h) - np.float32(0.5)
        k = np.arange(4)
        cx = np.floor(x).astype(np.int64)[..., None] + (k & 1)
        cy = np.floor(y).astype(np.int64)[..., None] + (k >> 1)
        inb = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
        tok = (cy * w + cx)[inb]
        img, qq, head, pt, kk = (i[inb] for i in ids)

        def per_row(group):
            return round(float(len(tok)) / len(np.unique(
                group.astype(np.int64) * (h * w) + tok)), 3)

        at_warp = (img * warp.max() + warp[qq]) * m + head
        out[f"level {lvl}"] = {
            "corners": int(len(tok)),
            "same_k": per_row((at_warp * p + pt) * 4 + kk),
            "any_k": per_row(at_warp * p + pt),
            "block": per_row((img * len(runs) + run[qq]) * m + head)}
    return out


def atomics_in_sass(lib: str) -> dict:
    """Counts of the atomic instructions in a library's machine code."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    ops = re.findall(r"\b((?:ATOMS|ATOMG|ATOM|REDG|RED)\.[A-Z0-9.]+)", sass)
    return dict(collections.Counter(ops))


def tune_bf16(a, dev) -> None:
    import torch

    import chip_smoke as cs
    from bench_msda_torch import msda_cases
    from monosowa_tpu_torch.ops import _build, msda
    from monosowa_tpu_torch.timing import device_ms

    shapes = cs.ENC_SHAPES
    cases = {label: args for (label, _), args in
             msda_cases(dev, (torch.bfloat16,)).items()}

    for label, setting in BF16_SETTINGS:
        res = {"setting": label, **setting}
        with constants(msda, setting):
            for shape, (value, loc, aw, dout) in cases.items():
                res[shape + " fwd"] = device_ms(
                    lambda: msda.ms_deform_attn(value, shapes, loc, aw),
                    a.reps)
                res[shape + " bwd"] = device_ms(
                    lambda: msda._launch_bwd(value, shapes, loc, aw, dout),
                    a.reps)
        print(json.dumps(res), flush=True)

    log = _build.build("msda_bwd_levers", LEVER_DIR)
    lib = _build.load_library("msda_bwd_levers", LEVER_DIR)
    walk = lib.lever_bwd_bf16
    walk.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 18 \
        + [ctypes.c_void_p]
    owner = lib.lever_owner_bf16
    owner.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    lists = lib.lever_lists_bf16
    lists.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 11 \
        + [ctypes.c_void_p]
    ranked = lib.lever_sorted_bf16
    ranked.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 12 \
        + [ctypes.c_void_p]
    walk.restype = owner.restype = lists.restype = ranked.restype = \
        ctypes.c_int

    def check(err, name):
        if err != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")

    def lever_plan(value, loc, knobs):
        """The block map of the levers' walk, under ``knobs``."""
        b, _, m, d = value.shape
        with constants(msda, knobs):
            return msda.msda_plan(shapes, loc.shape[1], loc.shape[4], d, dev,
                                  2, b * m)

    def lever_call(value, loc, aw, dout, plan, threads, dot_warps, role,
                   merge, merge_mask, skip_mask, extra_smem=0):
        """(dvalue bf16, dloc, daw) of one lever of the walk, None for
        what it does not compute."""
        b, s, m, d = value.shape
        q, n_levels, p = loc.shape[1], loc.shape[3], loc.shape[4]
        dvalue = torch.empty(value.shape, device=dev, dtype=torch.float32)
        dloc, daw = torch.empty_like(loc), torch.empty_like(aw)
        check(walk(value.data_ptr(), loc.data_ptr(), aw.data_ptr(),
                   dout.data_ptr(), dvalue.data_ptr(), dloc.data_ptr(),
                   daw.data_ptr(), plan.order.data_ptr(),
                   plan.runs.data_ptr(), ctypes.addressof(plan.level_hw),
                   n_levels, plan.n_runs, plan.max_run, plan.resident_mask,
                   plan.grad_mask, b, s, q, m, d, p, threads, dot_warps,
                   role, merge, merge_mask, skip_mask, extra_smem,
                   torch.cuda.current_stream().cuda_stream),
              "lever_bwd_bf16")
        alone = 0 if dot_warps else role
        return (None if alone == 1 else dvalue.to(torch.bfloat16),
                None if alone == 2 else dloc, None if alone == 2 else daw)

    def lists_call(value, loc, aw, dout, plan, threads):
        """(dvalue bf16, dloc, daw) with dvalue summed in the block by
        lists."""
        b, s, m, d = value.shape
        q, n_levels, p = loc.shape[1], loc.shape[3], loc.shape[4]
        dvalue = torch.empty(value.shape, device=dev, dtype=torch.float32)
        dloc, daw = torch.empty_like(loc), torch.empty_like(aw)
        check(lists(value.data_ptr(), loc.data_ptr(), aw.data_ptr(),
                    dout.data_ptr(), dvalue.data_ptr(), dloc.data_ptr(),
                    daw.data_ptr(), plan.order.data_ptr(),
                    plan.runs.data_ptr(), ctypes.addressof(plan.level_hw),
                    n_levels, plan.n_runs, plan.max_run, plan.resident_mask,
                    b, s, q, m, d, p, threads,
                    torch.cuda.current_stream().cuda_stream),
              "lever_lists_bf16")
        return dvalue.to(torch.bfloat16), dloc, daw

    def sorted_call(value, loc, aw, dout, plan, sort_mask, threads=1024):
        """(dvalue bf16, dloc, daw) with the levels of ``sort_mask`` summed
        in the block by a counting sort."""
        b, s, m, d = value.shape
        q, n_levels, p = loc.shape[1], loc.shape[3], loc.shape[4]
        dvalue = torch.empty(value.shape, device=dev, dtype=torch.float32)
        dloc, daw = torch.empty_like(loc), torch.empty_like(aw)
        check(ranked(value.data_ptr(), loc.data_ptr(), aw.data_ptr(),
                     dout.data_ptr(), dvalue.data_ptr(), dloc.data_ptr(),
                     daw.data_ptr(), plan.order.data_ptr(),
                     plan.runs.data_ptr(), ctypes.addressof(plan.level_hw),
                     n_levels, plan.n_runs, plan.max_run,
                     plan.resident_mask, b, s, q, m, d, p, threads,
                     sort_mask,
                     torch.cuda.current_stream().cuda_stream),
              "lever_sorted_bf16")
        return dvalue.to(torch.bfloat16), dloc, daw

    def owner_call(value, loc, aw, dout, scratch):
        """dvalue (bf16) by the atomic-free owner sum."""
        b, s, m, d = value.shape
        q, n_levels, p = loc.shape[1], loc.shape[3], loc.shape[4]
        dvalue = torch.empty_like(value)
        check(owner(loc.data_ptr(), aw.data_ptr(), dout.data_ptr(),
                    dvalue.data_ptr(), *[t.data_ptr() for t in scratch],
                    ctypes.addressof(msda.msda_plan(
                        shapes, q, p, d, dev, 2, b * m).level_hw),
                    n_levels, b, s, q, m, d, p,
                    torch.cuda.current_stream().cuda_stream),
              "lever_owner_bf16")
        return dvalue

    def owner_scratch(value, loc):
        """count, offset, cursor, tile sums, entries of the owner sum."""
        b, s, m, _ = value.shape
        rows = b * s * m
        ints = dict(device=dev, dtype=torch.int32)
        return (torch.empty(rows, **ints), torch.empty(rows + 1, **ints),
                torch.empty(rows, **ints),
                torch.empty(-(-rows // 1024), **ints),
                torch.empty(loc[..., 0].numel() * 8, **ints))

    def held(got, want):
        """Largest error over max abs of each output, and whether every
        output holds chip_smoke.py's bars (1e-5 of max abs; a bf16 dvalue
        one bf16 step more)."""
        errs, ok = {}, True
        for name, g, w in zip(("dvalue", "dloc", "daw"), got, want):
            if g is None:
                continue
            diff = (g.float() - w.float()).abs()
            scale = float(w.float().abs().max())
            bar = torch.full_like(diff, 1e-5 * scale)
            if name == "dvalue":
                bar = bar + cs.bf16_step(torch.maximum(g.float().abs(),
                                                       w.float().abs()))
            errs[name] = float(diff.max()) / scale
            ok = ok and bool(torch.isfinite(g).all()) \
                and bool((diff <= bar).all())
        return errs, ok

    for rnd in range(a.rounds):
        for shape in ("encoder", "encoder wide"):
            value, loc, aw, dout = cases[shape]
            dloc_p, daw_p = msda.msda_grad_loc_aw_plain(value, shapes, loc,
                                                        aw, dout)
            want = (msda.msda_grad_value_plain(value.shape, shapes, loc, aw,
                                               dout, value.dtype),
                    dloc_p, daw_p)
            scratch = owner_scratch(value, loc)
            rows = [("shipped", lambda: msda._launch_bwd(
                value, shapes, loc, aw, dout), True)]
            for label, threads, dot_warps, role, merge, merge_mask, \
                    skip_mask, knobs in LEVERS:
                plan = lever_plan(value, loc, knobs)
                rows.append((label, lambda pl=plan, t=threads, w=dot_warps,
                             r=role, mg=merge, mm=merge_mask, sk=skip_mask:
                             lever_call(value, loc, aw, dout, pl, t, w, r,
                                        mg, mm, sk),
                             (role == 0 or dot_warps > 0) and not skip_mask))
            dots = lever_plan(value, loc, {})
            rows.append(("lists: dvalue summed in the block, one add a "
                         "row", lambda: lists_call(value, loc, aw, dout,
                                                   dots, 1024), True))
            for lo in (1, 2, 3):
                rows.append((f"counting sort in the block on levels {lo}-3",
                             lambda mask=0b1111 >> lo << lo: sorted_call(
                                 value, loc, aw, dout, dots, mask), True))
            half = lever_plan(value, loc, {"RUN_TILES": 1})
            for lo in (1, 2, 3):
                rows.append((f"counting sort in the block on levels {lo}-3, "
                             "runs of one tile, blocks of 512 threads",
                             lambda mask=0b1111 >> lo << lo: sorted_call(
                                 value, loc, aw, dout, half, mask, 512),
                             True))
            for lo in (2, 3):
                rows.append((f"counting sort in the block on levels {lo}-3, "
                             "blocks of 512 threads",
                             lambda mask=0b1111 >> lo << lo: sorted_call(
                                 value, loc, aw, dout, dots, mask, 512),
                             True))
            rows.append(("counting sort in the block on levels 2-3, runs of "
                         "one tile, blocks of 256 threads",
                         lambda: sorted_call(value, loc, aw, dout, half,
                                             0b1100, 256), True))
            for tile in ((8, 16), (16, 8)):
                plan = lever_plan(value, loc, {"TILE_H": tile[0],
                                               "TILE_W": tile[1],
                                               "RUN_TILES": 1})
                rows.append((f"counting sort in the block on levels 2-3, "
                             f"runs of one {tile[0]} x {tile[1]} tile, "
                             f"blocks of 512 threads",
                             lambda pl=plan: sorted_call(
                                 value, loc, aw, dout, pl, 0b1100, 512),
                             True))
            rows.append(("lists, runs of one tile, blocks of 512 threads",
                         lambda: lists_call(value, loc, aw, dout, half,
                                            512), True))
            lists_smem = 4 * sum(h * w for h, w in shapes) + dots.max_run \
                * cs.N_POINTS * len(shapes) * 32 + dots.max_run * 128
            rows.append(("dots alone with the lists' shared memory asked "
                         "for and not used", lambda: lever_call(
                             value, loc, aw, dout, dots, 1024, 0, 1, 0, 0, 0,
                             lists_smem), False))
            rows.append(("owner sum: dvalue alone", lambda: (owner_call(
                value, loc, aw, dout, scratch), None, None), True))
            rows.append(("owner sum with the dots alone: a whole backward",
                         lambda: (owner_call(value, loc, aw, dout, scratch),
                                  *lever_call(value, loc, aw, dout, dots,
                                              1024, 0, 1, 0, 0, 0)[1:]),
                         True))
            rows.append(("shipped", lambda: msda._launch_bwd(
                value, shapes, loc, aw, dout), True))
            for label, fn, whole in rows:
                errs, ok = held(fn(), want)
                print(json.dumps({
                    "lever": label, "shape": shape, "round": rnd,
                    "ms": device_ms(fn, a.reps), "max_err_over_max_abs": errs,
                    "ok": ok, "whole_backward": whole}), flush=True)

    print(json.dumps({"lever_kernels": cs.ptxas_registers(log)}), flush=True)
    shipped = glob.glob(os.path.join(_build.BUILD_DIR, "msda_bwd-*.so"))
    print(json.dumps({"sass_atomics": {
        "msda_bwd": atomics_in_sass(shipped[0])}}), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser("MSDA lever sweep (torch / CUDA)")
    p.add_argument("--dtype", choices=("float32", "bf16"), default="float32",
                   help="value's type: which kernels and levers")
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--rounds", type=int, default=2,
                   help="bf16: times the backward's levers are measured, "
                        "in turns")
    p.add_argument("--duplicates", action="store_true",
                   help="only print, by level, how many corner adds of the "
                        "encoder's inputs (near and wide) share a dvalue "
                        "row in a warp and in a block (no card needed)")
    a = p.parse_args(argv)
    import torch

    if a.duplicates:
        import chip_smoke as cs
        from bench_msda_torch import msda_cases

        for (shape, _), (_, loc, _, _) in msda_cases(
                torch.device("cpu"), (torch.float32,)).items():
            if shape.startswith("encoder"):
                print(json.dumps({"shape": shape, **duplicate_rows(
                    loc.numpy(), cs.ENC_SHAPES)}), flush=True)
        return 0

    if not torch.cuda.is_available():
        print("tune_msda_torch: no CUDA device", file=sys.stderr)
        return 2
    print(nvidia_smi(), flush=True)
    dev = torch.device("cuda", 0)
    (tune_bf16 if a.dtype == "bf16" else tune_float32)(a, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
