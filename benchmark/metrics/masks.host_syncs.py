"""Mean times a mask frame's host waits on the card: the port's ``sync``
counter of the frame, over the window's untraced frames (the port's
tracer)."""

from port_spans import unit_mean


def read(ctx):
    return unit_mean(ctx, "masks.frame", lambda r: r.counts.get("sync", 0))
