"""Per-stage timing and device profiling hooks.

Port of salve_tpu/utils/profiler.py: the stage timer registry is a copy;
`device_trace` records a `torch.profiler` trace (CPU and, where there is a
card, CUDA activity) and writes it as a Chrome trace into `log_dir`, and
`annotate` names a region in it with `torch.profiler.record_function`.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

from salve_tpu_torch.training.meters import AverageMeter

_STAGE_METERS: Dict[str, AverageMeter] = defaultdict(AverageMeter)


@contextlib.contextmanager
def stage_timer(stage_name: str) -> Iterator[None]:
    """Accumulate wall-clock for a named pipeline stage."""
    t0 = time.time()
    try:
        yield
    finally:
        _STAGE_METERS[stage_name].update(time.time() - t0)


def record_stage(stage_name: str, seconds: float) -> None:
    """Non-context form of stage_timer for measurements taken inline."""
    _STAGE_METERS[stage_name].update(seconds)


def stage_summary() -> Dict[str, Dict[str, float]]:
    """{stage: {total_s, mean_s, count}} for all timed stages so far."""
    return {
        name: {"total_s": m.sum, "mean_s": m.avg, "count": int(m.count)}
        for name, m in _STAGE_METERS.items()
    }


def reset_stage_timers() -> None:
    _STAGE_METERS.clear()


def save_stage_summary(json_fpath: str) -> None:
    from salve_tpu_torch.utils.io import save_json_file

    save_json_file(json_fpath, stage_summary())


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """torch.profiler trace into `log_dir`/trace.json; no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside a device trace (torch.profiler.record_function)."""
    import torch

    with torch.profiler.record_function(name):
        yield
