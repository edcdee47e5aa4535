"""K2 + K3, the float32 MSDA backward kernel (``ops/csrc/msda_bwd.cu``):
the traced launches' bound over their summed kernel time."""

from bench_harness import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "msda_bwd_kernel", backward=True)
