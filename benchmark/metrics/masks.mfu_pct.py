"""A frame's analytic operations (``bench_flops.mask2former_frame``) over
the mean frame time, as a share of the card's float32 peak."""

from bench_harness import mfu_pct


def read(ctx):
    return mfu_pct(ctx, "frame_flops", "frame")
