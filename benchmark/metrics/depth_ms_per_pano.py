"""Device time of the kernels launched while a floor's depth is computed on
the card (HoHoNet in float32, `bench/depth`), over the panos computed, in
ms (device trace)."""

from benchmark.metrics._depth import ms_per_pano


def read(ctx):
    return ms_per_pano(ctx)
