"""B1's share of its roofline over its launches inside the traced floors'
banks, found by kernel name, eager or replayed as a graph (device trace)."""

from benchmark.metrics._banks import banks_roofline_pct


def read(ctx):
    return banks_roofline_pct(ctx, "b1")
