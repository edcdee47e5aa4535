"""Mean host wait, per step, for the loader's next batch (the span around
the benchmark's ``next()`` on ``data/loader.py``'s epoch iterator)."""

from bench_harness import untraced_mean


def read(ctx):
    t = untraced_mean(ctx, "loader_wait")
    return None if t is None else 1e3 * t
