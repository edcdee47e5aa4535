"""The share of a frame with no operation on the card: one minus the
device-busy seconds of a traced frame (device trace) over the mean untraced
frame (span)."""

from bench_harness import idle_pct


def read(ctx):
    return idle_pct(ctx, "frame")
