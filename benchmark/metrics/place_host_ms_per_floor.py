"""Host time in the scorer's `salve/place` spans (the walk that finds the
verifier, and HoHoNet where the floor came without depth, on the card in
eval mode and yields their graph keys; `.to` and `.eval` only for a model
that is not) over its `salve/floor` spans, in ms (program span). Read in
either scoring cell. None where no floor has a `place` span (a program
older than the span), and on the CPU, where no card waits on it."""

from benchmark.metrics._spans import ms_per, named, record


def read(ctx):
    spans = record(ctx, "fused_scoring") or record(ctx, "fresh_scoring")
    if spans is None or ctx.get("kind") == "cpu" or not named(spans, "salve/place"):
        return None
    return ms_per(spans, "salve/place", "salve/floor")
