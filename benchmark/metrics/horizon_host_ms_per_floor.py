"""Host time in the scorer's `salve/horizon` spans (the floor's HorizonNet
dispatch and the queued copy of its boundaries) over its `salve/floor`
spans, in ms (program span). None where no floor has a `horizon` span (a
program without the stage)."""

from benchmark.metrics._spans import ms_per, named, record


def read(ctx):
    spans = record(ctx, "horizon_scoring")
    if spans is None or not named(spans, "salve/horizon"):
        return None
    return ms_per(spans, "salve/horizon", "salve/floor")
