"""Device time of the kernels launched while layouts are rasterized (pano 2's
bank a floor, pano 1's rows a batch: `bench/layout`), over the traced
floors' batches, in ms (device trace)."""

from benchmark.metrics._layout import kernels


def read(ctx):
    found, batches = kernels(ctx), ctx.get("batches", 0)
    if found is None or batches <= 0:
        return None
    return 1e3 * sum(k.dur for k in found) / batches
