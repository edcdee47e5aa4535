"""A training step's analytic operations (the forward, and the backward as
twice every trained layer's forward; ``bench_flops.monodetr_train_flops``)
over the mean step time, as a share of the card's float32 peak."""

from bench_harness import mfu_pct


def read(ctx):
    return mfu_pct(ctx, "step_flops", "step")
