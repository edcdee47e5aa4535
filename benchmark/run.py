"""Runs one cell of the benchmark once and prints its result as the last
line of standard output.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: a configuration
under a traffic mix.  The run builds the port's system under test from the
seed, warms every shape the traffic uses (set-up), measures for
``--seconds`` seconds, then checks what the timed path produced against
the configuration's plain reference.  With ``--trace 0`` the metrics are
the cell's end-to-end ones; with ``--trace 1`` a profiler traces a part
of the window and the metrics are the per-layer ones.

The run fails, and prints no result, on a machine without the cards the
cell asks for, and if the JAX package or JAX is loaded after set-up or once
the window has closed.
"""

from __future__ import annotations

import time

T_IMPORT = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
for p in (HERE, os.path.dirname(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)

# libraries the port may import must not bring JAX in with them
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
os.environ.setdefault("USE_TF", "0")

import bench_harness as bh  # noqa: E402


class NoDevice(RuntimeError):
    pass


def check_device(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is False: this benchmark "
                       "measures the port on a CUDA card and has no CPU "
                       "fallback")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell asks for {chips} cards, "
                       f"{torch.cuda.device_count()} are visible")


def check_no_jax() -> None:
    """Raises if JAX, what it runs on, or the JAX package is loaded."""
    found = bh.forbidden_modules()
    if found:
        raise RuntimeError(f"the run loaded {found}: the benchmark measures "
                           "the port alone")


def run_cell(bench: bh.Bench, cell_name: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t_start: float = T_IMPORT,
             overrides=None) -> dict:
    """One run of ``cell_name``: the result dict (the printed line's
    keys).  ``overrides`` (tests only) are merged into the configuration
    and the traffic ({"config": {...}, "traffic": {...}, "limits":
    {...}}) and may hold ``fault``, the name of a fault the driver plants
    in the timed path."""
    import torch

    overrides = overrides or {}
    cell = bench.cell(cell_name)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    config.update(overrides.get("config", {}))
    traffic.update(overrides.get("traffic", {}))
    limits = bh.load_json(os.path.join(bench.dir, "checks",
                                       cell_name + ".json"))["limits"]
    limits.update(overrides.get("limits", {}))
    driver = bench.driver(traffic)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    # the port builds its native libraries into the checkout at first use:
    # a run that finds them missing builds them in its set-up
    libs_before = set(bh.built_libraries(bench.root))

    run = driver.Cell(config, traffic, seed, dev, trace,
                      reference=bench.reference(cell["config"]),
                      fault=overrides.get("fault"))
    run.setup()
    check_no_jax()
    built = sorted(set(bh.built_libraries(bench.root)) - libs_before)
    host = bh.HostClock()
    t0 = time.time()
    setup_s = t0 - t_start
    # with --trace 1, after ``trace_skip`` untraced units the profiler traces
    # ``trace_units`` units of the device alone (busy time, kernel times),
    # then ``trace_gap_units`` with the host's calls too, which name the
    # idle gaps; the host's events cost time, so the busy share is read
    # from the first part
    skip = int(traffic["trace_skip"])
    units = int(traffic["trace_units"])
    marks = ({skip: "device", skip + units: "host",
              skip + units + int(traffic["trace_gap_units"]): None}
             if trace else {})
    parts, current = {}, None
    n = 0

    def start(kind):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts = [torch.profiler.ProfilerActivity.CUDA] + \
                (acts if kind == "host" else [])
            torch.cuda.synchronize(dev)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        return [prof, time.time(), None]

    def stop(part):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        part[0].__exit__(None, None, None)
        part[2] = time.time() - part[1]

    while True:
        if n in marks:
            if current is not None:
                stop(current)
            kind = marks[n]
            current = parts[kind] = start(kind) if kind else None
        run.step()
        n += 1
        if time.time() - t0 >= seconds:
            break
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    window_s = time.time() - t0
    host_window = host.summary(n)
    if current is not None:
        stop(current)
    # spans are read from the units before the profiler first started
    traced = list(range(skip, n)) if trace else []
    device_units = max(0, min(n, skip + units) - skip)
    device_info = (bh.device_summary(dev, cell["chips"])
                   if dev.type == "cuda" else
                   {"platform": "cpu", "kind": "cpu", "count": 1,
                    "memory_peak_bytes": 0})
    run.close_window()

    ctx = {"cell": cell, "config": config, "traffic": traffic,
           "setup_s": setup_s, "window_s": window_s, "steps": n,
           "units": run.units, "spans": run.spans, "traced_steps": traced,
           "traced_device_units": device_units if trace else 0,
           "counts": run.counts(), "peaks": bench.peaks()}
    result: dict = {}
    if "device" in parts:
        prof, _, secs = parts["device"]
        summary = bh.trace_summary(prof, secs)
        if "host" in parts:
            summary["breakdown"]["idle_gaps"] = bh.trace_summary(
                parts["host"][0], parts["host"][2])["breakdown"]["idle_gaps"]
        ctx["trace"] = summary
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
        result["breakdown"] = summary["breakdown"]
        parts.clear()

    metrics = {}
    for m in bench.metrics(cell_name, trace):
        value = bench.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    correct, checks = run.check(limits)
    result["diagnostics"] = getattr(run, "diagnostics", {})
    check_no_jax()
    result = {"correct": bool(correct), "attempted": int(run.attempted),
              "failed": int(run.failed), "metrics": metrics,
              "device": device_info, **result,
              "card": bh.power_limit() if dev.type == "cuda" else "cpu",
              "work": {"units": run.units, "steps": n, "window_s": window_s,
                       "spans_ms_p10_p50_p90": {
                           k: [1e3 * v for v in bh.quantiles(t, (10, 50, 90))]
                           for k, t in run.spans.times.items()},
                       **{k: v for k, v in ctx["counts"].items()
                          if not isinstance(v, list)}},
              "setup": {"setup_s": setup_s, "kernels_built": built,
                        "first_run_of_checkout": bool(built),
                        **({"phases": run.setup_phases}
                           if hasattr(run, "setup_phases") else {})},
              "host": dict(host_window, card_after=bh.card_clocks()
                           if dev.type == "cuda" else "cpu"),
              "checks": checks}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--pending", type=int, choices=(0, 1), default=0,
                    help="1: the cell may be one held back in pending/")
    args = ap.parse_args(argv)
    try:
        t_start = bh.process_start_epoch()
    except (OSError, ValueError, StopIteration):
        t_start = T_IMPORT
    bench = bh.Bench(pending=bool(args.pending))
    cell = bench.cell(args.workload)
    try:
        check_device(int(cell["chips"]))
    except NoDevice as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 3
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=t_start)
    print(f"card: {result['card']}", file=sys.stderr)
    setup = result["setup"]
    print(f"setup_s {setup['setup_s']!r}: "
          + (f"this run built {', '.join(setup['kernels_built'])}"
             if setup["first_run_of_checkout"]
             else "the kernels were built before this run"),
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
