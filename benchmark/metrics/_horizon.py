"""What the horizon stage's readers share: the device time of the kernels
launched inside the traced floors' `bench/horizon` ranges (the scorer's
`floor_boundary_bank`, which the horizon_scoring driver wraps: HorizonNet's
forwards), over the panos whose boundary they computed, in ms. None where
no traced range holds a kernel (another driver's run, or the CPU)."""

from __future__ import annotations

from typing import Optional


def ms_per_pano(ctx) -> Optional[float]:
    t = ctx.get("trace")
    panos = sum(r["panos"] for r in ctx.get("launches", {}).get("horizon", []))
    if ctx.get("driver") != "horizon_scoring" or t is None or panos <= 0:
        return None
    kernels = t.kernels_in("horizon")
    if not kernels:
        return None
    return 1e3 * sum(k.dur for k in kernels) / panos
