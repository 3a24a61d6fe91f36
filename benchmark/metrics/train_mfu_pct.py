"""The train step's model FLOPs (three verifier forwards a tuple, from the
published architecture) over the traced steps' untraced time, as a share
of the card's bf16 peak."""

from benchmark.metrics._common import mfu_pct


def read(ctx):
    return mfu_pct(ctx, "verifier_training", forwards=3.0)
