"""The port's tracer: spans, units and counters; and per-stage timing with
running mean/variance.

Spans.  ``span(name)`` times a block on the host clock
(``time.perf_counter``) and records its name, the span open around it
(its parent), its start and end, and the unit it belongs to.  A span's
self time is its duration less the part its children cover.  A wait on
the card is a span of its own, ``sync(what, device)``: named
``sync.<what>``, it counts ``sync`` and its duration is added to the
``wait`` of every span open around it, so that a span's host time
(duration less wait) leaves the card's time out.

Units.  ``unit(name)`` is a span that opens one unit of work (one frame).
When it closes, one :class:`Record` goes into a ring of the last
``RING`` records: each span name's summed duration, self time and wait
within the unit, and each counter's increment within it.  Spans outside
a unit add to the running totals alone.  A unit opened inside another
keeps its spans and counts in its own record, not the outer's (whose span
it is a child of).

Counters.  ``count(name, n)`` adds to the open unit and to the process
total, which ``counter(name)`` reads: the kernels' launches
(``msda.fwd_launches``, ``lap.jv_launches``, ...), ``sync``, and the CUDA
graphs' ``graph.captures`` and ``graph.replays`` (``utils/graphs.py``).
Inside ``Tracer.counts_kept`` a count goes to the block's own table alone:
a graph's capture keeps its launches there and counts them on each replay.

Everything is kept in memory; nothing is written while spans run.  The
tracer is process-wide (``TRACER``; the module's ``span``, ``unit``,
``sync``, ``count``, ``counter`` and ``reset_counters`` act on it) with a
stack of open spans per thread.  Inside :meth:`StageTimer.trace` every
span is also a ``torch.profiler.record_function`` range, so the spans
share the device trace's clock in the file it writes; elsewhere no range
is made.

:class:`StageTimer` keeps the behavioural contract of the JAX package's
``utils/timing.py`` (SURVEY.md §5.1): the reference brackets stages with
time.time_ns() and prints running mean/variance per stage
(main_class.py:290-413, metric3d.py:141-155, tester_helper.py:159-160).
Each stage is also a span.  :meth:`StageTimer.trace` records a
``torch.profiler`` trace (CPU and, where there is one, CUDA activity) into
a directory, as the JAX package's records a ``jax.profiler`` one.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import math
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional

# unit records kept (the last ones), and closed spans kept
RING = 4096
SPANS_KEPT = 1 << 16


class Record:
    """One closed unit: ``spans`` maps a span name to [calls, seconds, self
    seconds, wait seconds] summed over the unit (the unit's own span
    included), ``counts`` a counter to its increment within the unit."""

    __slots__ = ("name", "id", "start", "end", "spans", "counts")

    def __init__(self, name: str, uid: int):
        self.name, self.id = name, uid
        self.start = self.end = 0.0
        self.spans: Dict[str, List[float]] = {}
        self.counts: Dict[str, int] = {}

    def seconds(self, name: str) -> float:
        s = self.spans.get(name)
        return s[1] if s else 0.0

    def host_seconds(self, name: str) -> float:
        """Seconds of the spans ``name`` less the waits on the card inside
        them."""
        s = self.spans.get(name)
        return s[1] - s[3] if s else 0.0

    def wait_seconds(self) -> float:
        """Seconds the unit waited on the card (its ``sync.*`` spans)."""
        return self.spans[self.name][3]


class Span:
    """A timed block (``with tracer.span(name) as s``); after it closes
    ``s.seconds`` is its duration."""

    __slots__ = ("tracer", "name", "parent", "record", "start", "end",
                 "child", "wait", "_range")
    waits = False      # a wait on the card (``sync.*``)

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer, self.name = tracer, name
        self.child = self.wait = 0.0
        self._range = None

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def unit_id(self) -> Optional[int]:
        return None if self.record is None else self.record.id

    def __enter__(self):
        tr = self.tracer
        local = tr._local
        self.parent = local.top
        local.top = self
        self.record = local.unit
        if tr._range_fn is not None:
            self._range = tr._range_fn(self.name)
            self._range.__enter__()
        self.start = tr.clock()
        return self

    def __exit__(self, *exc):
        tr = self.tracer
        self.end = end = tr.clock()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        tr._local.top = p = self.parent
        dur = end - self.start
        if self.waits:
            self.wait = dur
            q = p
            while q is not None:
                q.wait += dur
                q = q.parent
        tr.spans.append(self)
        rec = self.record
        if rec is not None:
            _add(rec.spans, self.name, dur, dur - self.child, self.wait)
        else:
            with tr._lock:
                _add(tr.totals, self.name, dur, dur - self.child, self.wait)
        if p is not None:
            p.child += dur
        return False


class _Wait(Span):
    """``sync.<what>``: the host waits on the card; counts ``sync`` and is
    the wait of every span open around it."""

    __slots__ = ()
    waits = True

    def __enter__(self):
        Span.__enter__(self)
        self.tracer.count("sync")
        return self


class _Unit(Span):
    __slots__ = ("outer",)

    def __enter__(self):
        tr = self.tracer
        self.outer = tr._local.unit
        tr._local.unit = Record(self.name, next(tr._ids))
        Span.__enter__(self)
        self.record.start = self.start
        return self

    def __exit__(self, *exc):
        Span.__exit__(self, *exc)
        rec = self.record
        rec.end = self.end
        tr = self.tracer
        tr._local.unit = self.outer
        tr.records.append(rec)
        return False


def _add(table: Dict[str, List[float]], name: str, dur: float,
         self_s: float, wait: float) -> None:
    s = table.get(name)
    if s is None:
        table[name] = [1, dur, self_s, wait]
    else:
        s[0] += 1
        s[1] += dur
        s[2] += self_s
        s[3] += wait


class _Local(threading.local):
    top: Optional[Span] = None        # the innermost open span
    unit: Optional[Record] = None     # the innermost open unit's record
    kept: Optional[Dict[str, int]] = None   # counts_kept's table


_NULL = contextlib.nullcontext()


class Tracer:
    """Spans, units and counters (module docstring).  ``clock`` (tests: a
    fake one) gives seconds."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self.clock = clock
        self.records: "collections.deque[Record]" = collections.deque(
            maxlen=RING)
        self.spans: "collections.deque[Span]" = collections.deque(
            maxlen=SPANS_KEPT)
        # span name -> [calls, seconds, self seconds, wait seconds] of the
        # spans outside any unit
        self.totals: Dict[str, List[float]] = {}
        self.counters: Dict[str, int] = {}
        self._local = _Local()
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._range_fn = None

    def span(self, name: str) -> Span:
        return Span(self, name)

    def unit(self, name: str) -> Span:
        return _Unit(self, name)

    def sync(self, what: str, device):
        """A wait on the card, ``sync.<what>``, of work on ``device`` (a
        ``torch.device``); where that is no CUDA device nothing waits and
        nothing is recorded."""
        if device.type != "cuda":
            return _NULL
        return _Wait(self, "sync." + what)

    def count(self, name: str, n: int = 1) -> None:
        kept = self._local.kept
        if kept is not None:
            kept[name] = kept.get(name, 0) + n
            return
        rec = self._local.unit
        if rec is not None:
            rec.counts[name] = rec.counts.get(name, 0) + n
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def counter(self, name: str) -> int:
        """The process total of counter ``name``."""
        return self.counters.get(name, 0)

    def reset_counters(self, *names: str) -> None:
        """Sets the process totals of ``names`` to 0."""
        with self._lock:
            for name in names:
                self.counters[name] = 0

    @contextlib.contextmanager
    def counts_kept(self):
        """Within the block this thread's counts go to the yielded table
        alone, neither to the open unit nor to the process totals."""
        local = self._local
        before, local.kept = local.kept, {}
        try:
            yield local.kept
        finally:
            local.kept = before

    def window(self, name: str, steps: int, skip: Iterable[int] = ()
               ) -> Optional[List[Record]]:
        """The last ``steps`` records of unit ``name`` (a window's units,
        in order) less those at the window's indices ``skip``; None where
        the ring holds fewer than ``steps``."""
        recs = [r for r in list(self.records) if r.name == name]
        if steps <= 0 or len(recs) < steps:
            return None
        skip = set(skip)
        return [r for i, r in enumerate(recs[len(recs) - steps:])
                if i not in skip]

    @contextlib.contextmanager
    def ranges(self):
        """Within the block every span is also a profiler range."""
        import torch

        before = self._range_fn
        self._range_fn = torch.profiler.record_function
        try:
            yield
        finally:
            self._range_fn = before


TRACER = Tracer()
span = functools.partial(Span, TRACER)
unit = functools.partial(_Unit, TRACER)
sync = TRACER.sync
count = TRACER.count
counter = TRACER.counter
reset_counters = TRACER.reset_counters


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
    """with timer.stage("optimization"): ... -> running stats per stage;
    each stage is also a span of the tracer."""

    def __init__(self):
        self.stats: Dict[str, _Stat] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        with span(name):
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
        that TensorBoard's profiler plugin and Perfetto read); the tracer's
        spans opened in the block are ranges in it."""
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(
                activities=acts,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                    log_dir)):
            with TRACER.ranges():
                yield

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.stats.items()):
            lines.append(f"{name}: n={s.n} mean={s.mean * 1e3:.1f}ms "
                         f"std={math.sqrt(s.var) * 1e3:.1f}ms")
        return "\n".join(lines)
