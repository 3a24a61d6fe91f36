"""The layout stage's share of its roofline: the least time of the traced
raster calls' work (benchmark/layout_work.py: the u8 rasters written and
the vertices and segments read, over the card's bandwidth, or the crossings
and the lines' bands over its float32 rate, whichever is larger, a call)
over the device time of the kernels they launched (device trace)."""

from benchmark.metrics._layout import kernels
from benchmark.rooflines import least_seconds


def read(ctx):
    found = kernels(ctx)
    if found is None:
        return None
    least = [least_seconds(r["bytes"], r["ops"], ctx.get("kind", "")) for r in ctx["launches"]["layout"]]
    spent = sum(k.dur for k in found)
    if None in least or spent <= 0:
        return None
    return 100.0 * sum(least) / spent
