"""B3's share of its roofline over the traced floors (device trace)."""

from benchmark.metrics._common import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "b3")
