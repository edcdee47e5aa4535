"""K1, the float32 MSDA forward kernel (``ops/csrc/msda_fwd.cu``): the
traced launches' bound (compulsory bytes or operations at the card's
peaks, from the shapes) over their summed kernel time."""

from bench_harness import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "msda_fwd_kernel", backward=False)
