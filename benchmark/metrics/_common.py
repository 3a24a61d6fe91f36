"""Arithmetic the metric readers share. Each reader is a file of its own,
`<metric name>.py`, with `read(ctx)`: the metric's value, or None where the
traced run holds nothing to read it from (the harness then leaves it out).

The shares of the card's time take as their window the traced work's own
time on the host's clock, run once untraced just before it
(`plain_window_s`): the profiler lengthens the host's work, so the traced
window itself would count its overhead as idle time.
"""

from __future__ import annotations

from typing import Optional

from benchmark.flops import forward_flops
from benchmark.rooflines import least_seconds, peaks


def idle_pct(ctx, driver: str) -> Optional[float]:
    """The share of the untraced time of the traced work in which the trace
    shows no kernel, copy or fill on the card. Where the profiler lengthens
    the card's own work the busy time reads high, so the share is a lower
    bound of the idle share."""
    t, plain = ctx.get("trace"), ctx.get("plain_window_s", 0.0)
    if ctx.get("driver") != driver or t is None or plain <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / plain)


def mfu_pct(ctx, driver: str, forwards: float) -> Optional[float]:
    """Model FLOPs of `forwards` forward passes a unit of work over the
    untraced time of the traced work, as a share of the card's bf16 peak."""
    p, plain = peaks(ctx.get("kind", "")), ctx.get("plain_window_s", 0.0)
    units = ctx.get("units", 0)
    if ctx.get("driver") != driver or p is None or units <= 0 or plain <= 0:
        return None
    flops = units * forwards * forward_flops(ctx["arch"], ctx["px"])
    return 100.0 * flops / plain / p["bf16_flops"]


def roofline_pct(ctx, layer: str) -> Optional[float]:
    """A kernel's least time over its measured time, summed over the
    traced launches (each launch's kernel is the one started in its range)."""
    t = ctx.get("trace")
    records = ctx.get("launches", {}).get(layer, [])
    if t is None or not records:
        return None
    kernels = t.kernels_in(layer)
    if len(kernels) != len(records):
        return None
    least = [least_seconds(r["bytes"], r["ops"], ctx.get("kind", "")) for r in records]
    spent = sum(k.dur for k in kernels)
    if None in least or spent <= 0:
        return None
    return 100.0 * sum(least) / spent
