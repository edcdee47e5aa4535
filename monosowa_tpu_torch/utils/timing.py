"""Per-stage timing counters with running mean/variance.

Behavioural contract (SURVEY.md §5.1; the JAX package's
``utils/timing.py``): the reference brackets stages with time.time_ns()
and prints running mean/variance per stage (main_class.py:290-413,
metric3d.py:141-155, tester_helper.py:159-160).  :meth:`StageTimer.trace`
records a ``torch.profiler`` trace (CPU and, where there is one, CUDA
activity) into a directory, as the JAX package's records a
``jax.profiler`` one.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Dict


class _Stat:
    __slots__ = ("n", "mean", "m2")

    def __init__(self):
        self.n = 0
        self.mean = 0.0
        self.m2 = 0.0

    def add(self, x: float) -> None:
        self.n += 1
        d = x - self.mean
        self.mean += d / self.n
        self.m2 += d * (x - self.mean)

    @property
    def var(self) -> float:
        return self.m2 / self.n if self.n > 1 else 0.0


class StageTimer:
    """with timer.stage("optimization"): ... -> running stats per stage."""

    def __init__(self):
        self.stats: Dict[str, _Stat] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stats.setdefault(name, _Stat()).add(
                time.perf_counter() - t0)

    @contextlib.contextmanager
    def trace(self, log_dir: str):
        """Wrap a block in a ``torch.profiler`` trace written into
        ``log_dir`` (a Chrome trace, ``<host>_<pid>.<time>.pt.trace.json``,
        that TensorBoard's profiler plugin and Perfetto read)."""
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(
                activities=acts,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                    log_dir)):
            yield

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.stats.items()):
            lines.append(f"{name}: n={s.n} mean={s.mean * 1e3:.1f}ms "
                         f"std={math.sqrt(s.var) * 1e3:.1f}ms")
        return "\n".join(lines)
