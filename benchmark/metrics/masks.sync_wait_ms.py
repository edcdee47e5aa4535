"""Mean ms a mask frame's host waits on the card: the port's ``sync.*``
spans of the frame (the upload, the group ids' copy, each group's
``nonzero`` and the kept masks' and scores' copies to the host), over the
window's untraced frames (the port's tracer)."""

from port_spans import unit_mean


def read(ctx):
    return unit_mean(ctx, "masks.frame", lambda r: 1e3 * r.wait_seconds())
