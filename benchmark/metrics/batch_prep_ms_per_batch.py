"""Host time in the scorer's `salve/prepare` spans (the padded chunk and
its two index and two pose tensors on the card) over its `salve/batch`
spans, in ms."""

from benchmark.metrics._spans import ms_per, record


def read(ctx):
    return ms_per(record(ctx, "fused_scoring"), "salve/prepare", "salve/batch")
