"""The share of a step with no operation on the card: one minus the
device-busy seconds of a traced step (device trace) over the mean untraced
step (span)."""

from bench_harness import idle_pct


def read(ctx):
    return idle_pct(ctx, "step")
