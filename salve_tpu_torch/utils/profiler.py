"""The port's tracing: spans, counters, per-stage timing and device traces.

Port of salve_tpu/utils/profiler.py (the stage timer registry is a copy),
grown into the one place the port records what it does.

Spans. `annotate(name, id=None, **counts)` marks a region of the host's work
as the span `salve/<name>`. Tracing is on exactly while a torch profiler is
recording (`torch.autograd._profiler_enabled()`): under `device_trace`, a
`torch.profiler.profile` of the caller's or any other profiling session.
There is no other switch.
  * Off, a span costs that one check and is the shared no-op `NOOP`.
  * On, a span opens `torch.profiler.record_function("salve/<name>")`, so it
    lands in the profiler's trace beside every kernel, copy and fill, and
    appends a `Span` to the in-memory record: its name, its parent, its
    start and end on the profiler's clock (CLOCK_REALTIME in ns: the Chrome
    trace's `ts` is that less the trace's `baseTimeNanoseconds`, in us), the
    thread, the id of the floor or step it belongs to (a root's `id`, which
    its children inherit) and its counts.
The record holds the last profiled stretch only: `device_trace` starts it
anew on entry, and so does the first span of any other stretch, which is
the first to find tracing on after `device_trace` ended or a span found
tracing off (two sessions of the caller's own with no span between them
share one record). `device_trace` writes it out, as
`spans.json` beside `trace.json`; `span_record()` reads it in the process.

Counters. `COUNTERS` holds running integer totals, always on (the kernel
wrappers' launch counts among them, device.py). `count(name, n)` adds to
one and, while tracing, to the innermost open span of the calling thread,
so that a reader of the record sees the counts of the traced stretch alone.

No span or counter synchronises with the card, allocates on it or reads a
value from it: counts come from shapes, `nbytes` and Python ints. A span
opens and closes on the calling thread.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

import torch

from salve_tpu_torch.training.meters import AverageMeter

SPAN_PREFIX = "salve/"
NOOP = contextlib.nullcontext()
_tracing = torch.autograd._profiler_enabled

_STAGE_METERS: Dict[str, AverageMeter] = defaultdict(AverageMeter)

COUNTERS: Dict[str, int] = defaultdict(int)
_COUNTERS_LOCK = threading.Lock()


class _OpenSpans(threading.local):
    def __init__(self) -> None:
        self.stack: List["Span"] = []


_OPEN = _OpenSpans()
_RECORD: List["Span"] = []
_record_live = False  # the record belongs to the profiled stretch under way


class Span:
    """One traced region (module docstring); made by `annotate` while tracing."""

    __slots__ = ("name", "index", "parent", "id", "thread", "start_ns", "end_ns", "counts", "_range")

    def __init__(self, name: str, id: Optional[int], counts: Dict[str, int]) -> None:
        self.name = SPAN_PREFIX + name
        self.id = id
        self.counts = counts
        self.end_ns: Optional[int] = None

    def __enter__(self) -> "Span":
        global _record_live
        if not _record_live:
            _RECORD.clear()
            _record_live = True
        stack = _OPEN.stack
        parent = stack[-1] if stack else None
        self.parent = None if parent is None else parent.index
        if self.id is None and parent is not None:
            self.id = parent.id
        self.thread = threading.get_native_id()
        self.index = len(_RECORD)
        _RECORD.append(self)
        stack.append(self)
        self._range = torch.profiler.record_function(self.name)
        self.start_ns = time.time_ns()
        self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._range.__exit__(*exc)
        self.end_ns = time.time_ns()
        self._range = None
        _OPEN.stack.pop()

    def as_dict(self) -> Dict:
        return {"name": self.name, "parent": self.parent, "id": self.id, "thread": self.thread,
                "start_ns": self.start_ns, "end_ns": self.end_ns, "counts": dict(self.counts)}


def annotate(name: str, id: Optional[int] = None, **counts: int):
    """The span `salve/<name>` (module docstring). `id` names the floor or
    step a root span stands for; `counts` are attached to the span as given
    (they do not add to `COUNTERS`)."""
    global _record_live
    if _tracing():
        return Span(name, id, counts)
    _record_live = False
    return NOOP


def count(name: str, n: int = 1) -> int:
    """Add `n` to the running total `name` and, while tracing, to the
    innermost open span of this thread; returns the new total."""
    with _COUNTERS_LOCK:
        COUNTERS[name] += n
        total = COUNTERS[name]
    stack = _OPEN.stack
    if stack:
        counts = stack[-1].counts
        counts[name] = counts.get(name, 0) + n
    return total


def counter(name: str) -> int:
    """The running total `name` (0 if never counted)."""
    return COUNTERS.get(name, 0)


def reset_counters(*names: str) -> None:
    """Set the totals `names` to 0."""
    with _COUNTERS_LOCK:
        for name in names:
            COUNTERS[name] = 0


def span_record() -> List[Dict]:
    """The spans of the last profiled stretch, in the order they opened;
    `parent` is the index of the parent span in this list."""
    return [s.as_dict() for s in list(_RECORD)]


def reset_span_record() -> None:
    """Start a fresh record for the profiled stretch about to begin."""
    global _record_live
    _RECORD.clear()
    _record_live = True


@contextlib.contextmanager
def stage_timer(stage_name: str) -> Iterator[None]:
    """Accumulate wall-clock for a named pipeline stage, inside the span of
    the same name."""
    t0 = time.perf_counter()
    try:
        with annotate(stage_name):
            yield
    finally:
        _STAGE_METERS[stage_name].update(time.perf_counter() - t0)


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
    """torch.profiler trace of the block (CPU and, where there is a card,
    CUDA activity) into `log_dir`/trace.json, and the block's spans and the
    counters into `log_dir`/spans.json; no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    global _record_live
    reset_span_record()
    try:
        with torch.profiler.profile(activities=activities) as prof:
            # The session's first range readies the profiler's buffers for this
            # thread, which takes up to a tenth of a millisecond between a span's
            # clock read and the profiler's: let a mark of the trace's start take it.
            with torch.profiler.record_function("device_trace/start"):
                pass
            yield
    finally:
        _record_live = False
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump({"clock": "CLOCK_REALTIME ns", "spans": span_record(), "counters": dict(COUNTERS)}, f)
