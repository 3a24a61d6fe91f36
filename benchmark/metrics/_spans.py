"""What the readers of the program's own spans share. The port records the
spans of the last profiled stretch (salve_tpu_torch/utils/profiler.py:
`span_record`): names under `salve/`, start and end in ns on the host's
clock, each span's counts. The traced run's stretch is the profiled pass
alone, so warm-up and the untraced pass never show in it.

The times are the host's under the profiler, which lengthens the host's
work: upper bounds of the untraced times (the harness prints the stretch's
traced/untraced ratio). A program that keeps no record (one older than the
spans) reads None, as does a record of another driver's run.
"""

from __future__ import annotations

from typing import Dict, List, Optional


def record(ctx, driver: str) -> Optional[List[Dict]]:
    """The closed spans of the traced stretch, or None."""
    if ctx.get("driver") != driver:
        return None
    from salve_tpu_torch.utils import profiler

    read = getattr(profiler, "span_record", None)
    spans = [s for s in read() if s["end_ns"] is not None] if read is not None else []
    return spans or None


def named(spans: List[Dict], name: str) -> List[Dict]:
    return [s for s in spans if s["name"] == name]


def ms_per(spans: Optional[List[Dict]], name: str, per: str, count: Optional[str] = None) -> Optional[float]:
    """Host ms in the spans `name` over the spans `per` (over the sum of
    their `count` where one is named)."""
    if spans is None:
        return None
    units = named(spans, per)
    n = sum(s["counts"].get(count, 0) for s in units) if count else len(units)
    if n <= 0:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in named(spans, name)) / 1e6 / n
