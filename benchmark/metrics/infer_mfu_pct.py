"""The scoring step's model FLOPs (one verifier forward a hypothesis
scored, padded rows not counted, from the published architecture) over the
traced floors' untraced time, as a share of the card's bf16 peak."""

from benchmark.metrics._common import mfu_pct


def read(ctx):
    return mfu_pct(ctx, "fused_scoring", forwards=1.0)
