"""Host time in the scorer's `salve/upload` spans (the floor's depth and
rgb banks as float32, copied to the card from pageable memory) over the
panos they uploaded, in ms."""

from benchmark.metrics._spans import ms_per, record


def read(ctx):
    return ms_per(record(ctx, "fused_scoring"), "salve/upload", "salve/upload", count="panos")
