"""Host time in the scorer's `salve/verifier` spans (ResNet-152's eval
dispatch with the softmax and argmax) over its `salve/batch` spans, in ms:
the host's share of a batch that a cheaper verifier dispatch would cut."""

from benchmark.metrics._spans import ms_per, record


def read(ctx):
    return ms_per(record(ctx, "fused_scoring"), "salve/verifier", "salve/batch")
