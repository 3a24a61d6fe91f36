"""HorizonNet's share of the card's float32 peak in the horizon stage: one
forward's FLOPs a pano (benchmark/flops_horizonnet.py, from the published
layer plan at the configuration's input size) over `horizon_ms_per_pano`'s
device time, as a share of the card's float32 rate (TF32 is off, so the
convolutions, the LSTM and the products run on the float32 units): the
stage's roofline share (device trace)."""

from benchmark.flops_horizonnet import forward_flops
from benchmark.metrics._horizon import ms_per_pano
from benchmark.rooflines import peaks


def read(ctx):
    ms, p, hw = ms_per_pano(ctx), peaks(ctx.get("kind", "")), ctx.get("horizon_hw")
    if ms is None or p is None or hw is None:
        return None
    return 100.0 * forward_flops(tuple(hw)) / (ms * 1e-3) / p["fp32_flops"]
