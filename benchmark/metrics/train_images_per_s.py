"""Training images completed over the whole window, each step finished on
the card (its losses copied to the host)."""


def read(ctx):
    return ctx["units"] / ctx["window_s"]
