"""Seconds from the process's start to the first timed unit: importing,
building and filling the network, writing the traffic's data, building
the kernels where the checkout has none, and warming every shape."""


def read(ctx):
    return ctx["setup_s"]
