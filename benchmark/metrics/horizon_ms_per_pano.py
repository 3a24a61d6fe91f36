"""Device time of the kernels launched while a floor's boundaries are
computed on the card (HorizonNet in float32, `bench/horizon`), over the
panos computed, in ms (device trace)."""

from benchmark.metrics._horizon import ms_per_pano


def read(ctx):
    return ms_per_pano(ctx)
