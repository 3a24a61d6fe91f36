"""What the layout stage's readers share: the kernels launched inside the
traced floors' `bench/layout` ranges (the scorer's `layout_rasters`, which
the layout_scoring driver wraps: pano 2's bank a floor, pano 1's rows a
batch) and the work of each range (benchmark/layout_work.py). None where no
traced range holds a kernel (another driver's run, or the CPU)."""

from __future__ import annotations

from typing import List, Optional

from benchmark.tracing import Kernel


def kernels(ctx) -> Optional[List[Kernel]]:
    t = ctx.get("trace")
    if ctx.get("driver") != "layout_scoring" or t is None or not ctx.get("launches", {}).get("layout"):
        return None
    return t.kernels_in("layout") or None
