"""K1 in the pixel decoder: the traced launches' bound over their summed
kernel time."""

from bench_harness import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "msda_fwd_kernel", backward=False)
