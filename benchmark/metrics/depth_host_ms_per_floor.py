"""Host time in the scorer's `salve/depth` spans (the floor's HoHoNet
dispatch and the millimetre conversion) over its `salve/floor` spans, in ms
(program span)."""

from benchmark.metrics._spans import ms_per, record


def read(ctx):
    return ms_per(record(ctx, "fresh_scoring"), "salve/depth", "salve/floor")
