"""What the depth stage's readers share: the device time of the kernels
launched inside the traced floors' `bench/depth` ranges (the scorer's
`depth_mm_bank`, which the fresh_scoring driver wraps), over the panos they
computed, in ms. None where no traced range holds a kernel (another
driver's run, or the CPU)."""

from __future__ import annotations

from typing import Optional


def ms_per_pano(ctx) -> Optional[float]:
    t = ctx.get("trace")
    panos = sum(r["panos"] for r in ctx.get("launches", {}).get("depth", []))
    if t is None or panos <= 0:
        return None
    kernels = t.kernels_in("depth")
    if not kernels:
        return None
    return 1e3 * sum(k.dur for k in kernels) / panos
