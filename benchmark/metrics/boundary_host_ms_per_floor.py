"""Host time in the scorer's `salve/boundary` spans (the wait for the
floor's boundaries, then each pano's room and W/D/Os: rounding,
backprojection, RDP) over its `salve/floor` spans, in ms (program span).
None where no floor has a `boundary` span (a program without the stage)."""

from benchmark.metrics._spans import ms_per, named, record


def read(ctx):
    spans = record(ctx, "horizon_scoring")
    if spans is None or not named(spans, "salve/boundary"):
        return None
    return ms_per(spans, "salve/boundary", "salve/floor")
