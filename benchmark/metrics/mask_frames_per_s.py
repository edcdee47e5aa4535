"""Frames whose kept masks reached the host, over the whole window."""


def read(ctx):
    return ctx["units"] / ctx["window_s"]
