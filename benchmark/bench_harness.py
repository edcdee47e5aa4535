"""The benchmark's harness: finds a cell's configuration, traffic and
metrics by name, holds the device to what the cell asks for, and turns a
run's clocks, spans and profiler trace into the result line.

Everything that belongs to one configuration, one traffic mix or one
metric lives in a file of its own, found by the name ``BENCHMARK.json``
gives it:

* ``configs/<config>.json``: the configuration as it is run; its
  ``family`` names the plain reference ``references/<config>.py``;
* ``workloads/<traffic>.json``: the traffic's parameters; its ``driver``
  names the code that drives the port under it (``drivers/<driver>.py``);
* ``metrics/<metric>.py``: a reader ``read(ctx)`` that returns the
  metric's value or None where the run gave it nothing to read.

So a later change adds a cell, a configuration or a metric by adding files
and entries, never by editing one that is here.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# loaded modules whose top-level name makes a run void: the JAX package and
# what it runs on (compared whole: the port's name begins with the JAX
# package's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "monosowa_tpu")
# the prefix of the benchmark's own profiler ranges
ANNOTATION = "bench."
# BENCHMARK.json's lists of named entries
SPEC_LISTS = ("configs", "workloads", "end_to_end", "per_layer")


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def pending_entries(bench_dir: str) -> List[Dict[str, Any]]:
    """The files of ``<bench_dir>/pending/``, in name order."""
    held = os.path.join(bench_dir, "pending")
    if not os.path.isdir(held):
        return []
    return [load_json(os.path.join(held, f))
            for f in sorted(os.listdir(held)) if f.endswith(".json")]


def load_module(path: str, name: Optional[str] = None):
    """The Python file at ``path`` as a fresh module."""
    name = name or "bench_" + os.path.splitext(os.path.basename(path))[0] \
        .replace("-", "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """``BENCHMARK.json`` and the files it names, under ``root``.  With
    ``pending``, also the entries of ``pending/<cell>.json``: cells that
    are built but held out of ``BENCHMARK.json`` (each file says why),
    which a later change copies into it.  ``BENCHMARK.json`` wins: a
    pending entry whose name it already lists under the same key is not
    taken again, so a pending file left in place once its entries have
    moved changes nothing."""

    def __init__(self, root: str = ROOT, pending: bool = False):
        self.root = root
        self.dir = os.path.join(root, "benchmark")
        self.spec = load_json(os.path.join(root, "BENCHMARK.json"))
        if pending:
            for extra in pending_entries(self.dir):
                for key in SPEC_LISTS:
                    have = {e["name"] for e in self.spec[key]}
                    self.spec[key] = self.spec[key] + [
                        e for e in extra.get(key, [])
                        if e["name"] not in have]

    def cell(self, name: str) -> Dict[str, Any]:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict[str, Any]:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return load_json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> Dict[str, Any]:
        return load_json(os.path.join(self.dir, "workloads", name + ".json"))

    def driver(self, traffic: Dict[str, Any]):
        return load_module(os.path.join(self.dir, "drivers",
                                        traffic["driver"] + ".py"))

    def reference(self, config_name: str):
        return load_module(os.path.join(self.dir, "references",
                                        config_name + ".py"))

    def metrics(self, cell: str, trace: bool) -> List[Dict[str, Any]]:
        """The metrics a run of ``cell`` reports: the end-to-end ones with
        ``trace`` off, the per-layer ones with it on."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.spec[key]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str) -> Callable[[Dict[str, Any]], Any]:
        return load_module(os.path.join(self.dir, "metrics",
                                        metric + ".py")).read

    def peaks(self) -> Dict[str, float]:
        return load_json(os.path.join(self.dir, "peaks.json"))


def process_start_epoch() -> float:
    """When this process started (wall clock), from ``/proc``."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    ticks = int(fields[19])            # starttime, field 22 of stat
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f
                     if line.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


def built_libraries(root: str = ROOT) -> List[str]:
    """The port's native libraries built in the checkout
    (``build/monosowa_tpu_torch/*.so``)."""
    d = os.path.join(root, "build", "monosowa_tpu_torch")
    return sorted(f for f in os.listdir(d) if f.endswith(".so")) \
        if os.path.isdir(d) else []


class HostClock:
    """What the host did over a window, from the process's own clocks: the
    process's CPU seconds (every thread) and the main thread's, which
    drives the port, against the wall clock.  A main thread busy for the
    whole window paces the run; its CPU time a unit then says how fast the
    host ran the same work."""

    def __init__(self):
        self.t0 = self._read()

    @staticmethod
    def _read() -> Tuple[float, float, float]:
        import time

        cpu = os.times()
        return time.time(), cpu.user + cpu.system, time.thread_time()

    def summary(self, units: int) -> Dict[str, Any]:
        wall, proc, thread = (b - a for a, b in zip(self.t0, self._read()))
        return {"window_s": wall, "process_cpu_s": proc,
                "main_thread_cpu_s": thread,
                "main_thread_busy_share": thread / wall if wall else None,
                "main_thread_cpu_ms_a_unit": 1e3 * thread / max(units, 1),
                "cpus": len(os.sched_getaffinity(0))}


def card_clocks() -> str:
    """The card's SM clock, its maximum, its temperature and power draw as
    ``nvidia-smi`` reads them, or "unknown"."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,"
             "temperature.gpu,power.draw", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.splitlines()[0] if out else "unknown"


def forbidden_modules(modules: Sequence[str] = ()) -> List[str]:
    """Loaded modules whose top-level name, the part before the first dot,
    is one of ``FORBIDDEN_MODULES``, compared whole."""
    names = modules or list(sys.modules)
    return sorted({n for n in names
                   if n.split(".", 1)[0] in FORBIDDEN_MODULES})


class Spans:
    """Durations of the benchmark's calls into the port's layers, by name,
    on the host clock (the drivers also name each call for the profiler,
    ``bench.<call>``)."""

    def __init__(self):
        self.times: Dict[str, List[float]] = {}

    def add(self, name: str, seconds: float) -> None:
        self.times.setdefault(name, []).append(seconds)

    def mean(self, name: str, skip: Sequence[int] = ()) -> Optional[float]:
        skip = set(skip)
        vals = [v for i, v in enumerate(self.times.get(name, []))
                if i not in skip]
        return sum(vals) / len(vals) if vals else None


def quantiles(values: Sequence[float], pcts: Sequence[int]) -> List[float]:
    v = sorted(values)
    return [v[min(len(v) - 1, int(p / 100 * len(v)))] for p in pcts] \
        if v else []


def seeded_frame(seed: int, h: int, w: int, block: int):
    """An (H, W, 3) uint8 RGB frame from ``seed``: a field of ``block``-pixel
    blocks with fine noise, which PNG stores at about a KITTI frame's
    size."""
    import numpy as np

    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, (h // block + 1, w // block + 1, 3))
    img = np.repeat(np.repeat(coarse, block, 0), block, 1)[:h, :w]
    img = img + rng.integers(-8, 9, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def device_summary(dev, chips: int) -> Dict[str, Any]:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": int(chips),
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them, or
    "unknown" where it cannot."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.splitlines()[0] if out else "unknown"


# ---------------------------------------------------------------------------
# the profiler's trace
# ---------------------------------------------------------------------------

def trace_summary(prof, window_s: float, top: int = 10) -> Dict[str, Any]:
    """From a ``torch.profiler`` run over a window of ``window_s`` seconds:
    the seconds some operation ran on the device (the union of the device
    events' intervals), each kernel's summed seconds and launches, the
    longest device operations, and the longest gaps with no operation on
    the device, each named by the innermost host span open across its
    middle."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev_iv: List[Tuple[float, float]] = []
    host: List[Tuple[float, float, str]] = []
    kernels: Dict[str, List[float]] = {}
    annotations: List[Tuple[float, float, str]] = []
    for e in prof.events():
        tr = e.time_range
        if e.name.startswith(ANNOTATION):
            # the benchmark's own ranges name host time, not device work
            annotations.append((tr.start, tr.end, e.name))
            continue
        if e.device_type == cuda:
            dev_iv.append((tr.start, tr.end))
            k = kernels.setdefault(e.name, [0.0, 0])
            k[0] += (tr.end - tr.start) * 1e-6
            k[1] += 1
        else:
            host.append((tr.start, tr.end, e.name))
    dev_iv.sort()
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e in dev_iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((s - cur_e, cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    gaps.sort(reverse=True)

    host += annotations

    def host_at(t: float) -> str:
        best = None
        for s, e, name in host:
            if s <= t <= e and (best is None or e - s < best[0]):
                best = (e - s, name)
        return best[1] if best else "no host span"

    idle = [[host_at((a + b) / 2), g * 1e-6] for g, a, b in gaps[:top]]
    ops = sorted(([n, v[0]] for n, v in kernels.items()),
                 key=lambda r: -r[1])[:top]
    return {"busy_s": busy * 1e-6, "window_s": window_s,
            "kernels": {n: {"seconds": v[0], "launches": v[1]}
                        for n, v in kernels.items()},
            "breakdown": {"device_ops": ops, "idle_gaps": idle}}


def kernel_seconds(ctx: Dict[str, Any], pattern: str
                   ) -> Tuple[float, int]:
    """Summed device seconds and launches of the traced kernels whose name
    holds ``pattern``."""
    secs, n = 0.0, 0
    for name, v in ctx.get("trace", {}).get("kernels", {}).items():
        if pattern in name:
            secs += v["seconds"]
            n += v["launches"]
    return secs, n


# ---------------------------------------------------------------------------
# what the metrics' readers share
# ---------------------------------------------------------------------------

def untraced_mean(ctx: Dict[str, Any], span: str) -> Optional[float]:
    """Mean seconds of a span over the window's units the profiler did not
    trace."""
    return ctx["spans"].mean(span, skip=ctx.get("traced_steps", ()))


def mfu_pct(ctx: Dict[str, Any], flops_key: str, span: str
            ) -> Optional[float]:
    """A unit's analytic operations over its mean time, as a share of the
    card's float32 peak."""
    t = untraced_mean(ctx, span)
    if not t:
        return None
    return 100.0 * ctx["counts"][flops_key] / t / ctx["peaks"]["float32_flops"]


def roofline_pct(ctx: Dict[str, Any], pattern: str, backward: bool
                 ) -> Optional[float]:
    """The traced launches' summed bound over their summed kernel time:
    each launch's bound from the shapes of the unit's MSDA calls, in the
    order the unit makes them."""
    import bench_flops

    secs, launches = kernel_seconds(ctx, pattern)
    calls = ctx["counts"].get("msda_calls") or []
    if not launches or not secs or not calls:
        return None
    per_unit = bench_flops.msda_bounds(calls, ctx["peaks"], backward)
    return 100.0 * per_unit * (launches / len(calls)) / secs


def idle_pct(ctx: Dict[str, Any], span: str) -> Optional[float]:
    """The share of a unit's time with no operation on the card: one minus
    the device-busy seconds of a traced unit over the mean untraced unit.
    The profiler's own work lengthens the traced units, so their window's
    idle share (``busy_s`` against ``window_s``) reads high."""
    tr = ctx.get("trace")
    t = untraced_mean(ctx, span)
    units = ctx.get("traced_device_units", 0)
    if not tr or not t or not tr["busy_s"] or not units:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / units / t)
