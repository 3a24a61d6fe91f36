"""Spans from outside the program, the device trace, and what it shows.

`Spans` wraps callables of the program (module functions, instance
methods) in `torch.profiler.record_function` ranges named `bench/<layer>`,
records the shapes of each hand-written kernel launch, and restores every
attribute on exit. Only the traced run installs them.

`profile(fn)` runs `fn` under the profiler (the host's `record_function`
ranges and all device activity, nothing else), writes the Chrome trace to
a temporary file, reads it and deletes it.
`TraceSummary` holds what the metric readers need: the window, the
device's busy time, each kernel with the innermost `bench/` range its launch
was made in (matched by the launch's correlation id), and the device's idle
gaps with the host range it waited in.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

PREFIX = "bench/"
WINDOW = PREFIX + "window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NAME_CHARS = 160


class Spans:
    """Install `bench/` ranges around program callables; `restore()` undoes it."""

    def __init__(self) -> None:
        self._patches: List[Tuple[object, str, object, bool]] = []
        self.launches: Dict[str, List[dict]] = defaultdict(list)

    def wrap(self, obj, attr: str, layer: str, record: Optional[Callable] = None) -> None:
        orig = getattr(obj, attr)
        own = attr in vars(obj)
        name = PREFIX + layer

        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(name):
                out = orig(*args, **kwargs)
            if record is not None:
                self.launches[layer].append(record(*args, **kwargs))
            return out

        setattr(obj, attr, wrapped)
        self._patches.append((obj, attr, orig, own))

    def restore(self) -> None:
        for obj, attr, orig, own in reversed(self._patches):
            if own:
                setattr(obj, attr, orig)
            else:
                delattr(obj, attr)
        self._patches.clear()


@dataclass
class Kernel:
    name: str
    dur: float  # seconds
    ranges: Tuple[str, ...]  # enclosing bench/ ranges of its launch, innermost first


@dataclass
class TraceSummary:
    window: Tuple[float, float]
    busy_s: float
    kernels: List[Kernel]
    gaps: List[Tuple[float, str]] = field(default_factory=list)  # (seconds, host range)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def kernels_in(self, layer: str) -> List[Kernel]:
        """Kernels launched inside a `bench/<layer>` range."""
        return [k for k in self.kernels if PREFIX + layer in k.ranges]

    def breakdown(self, top: int = 10) -> Dict[str, List[List]]:
        ops: Dict[str, float] = defaultdict(float)
        for k in self.kernels:
            ops[k.name[:NAME_CHARS]] += k.dur
        gaps: Dict[str, float] = defaultdict(float)
        for sec, where in self.gaps:
            gaps[where] += sec
        by = lambda d: [[n, s] for n, s in sorted(d.items(), key=lambda x: -x[1])[:top]]  # noqa: E731
        return {"device_ops": by(ops), "idle_gaps": by(gaps)}


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _stacks(host: List[Tuple[float, float, str]], queries: List[float]) -> List[Tuple[str, ...]]:
    """The bench/ ranges open at each query time, innermost first (the
    ranges nest: they are opened and closed on one thread)."""
    points = [(s, 0, n) for s, _, n in host] + [(e, 2, n) for _, e, n in host]
    points += [(t, 1, i) for i, t in enumerate(queries)]
    points.sort(key=lambda p: (p[0], p[1]))
    stack: List[str] = []
    out: List[Tuple[str, ...]] = [()] * len(queries)
    for _, kind, x in points:
        if kind == 0:
            stack.append(x)
        elif kind == 2:
            for j in range(len(stack) - 1, -1, -1):
                if stack[j] == x:
                    del stack[j]
                    break
        else:
            out[x] = tuple(reversed(stack))
    return out


def summarize(events: List[dict]) -> TraceSummary:
    """Read a Chrome trace's events (timestamps in microseconds)."""
    spans = [e for e in events if e.get("ph") == "X"]
    base = min(float(e["ts"]) for e in spans)

    def when(e) -> Tuple[float, float]:
        return (float(e["ts"]) - base) * 1e-6, float(e.get("dur", 0.0)) * 1e-6

    ranges: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    launch_at: Dict[int, float] = {}
    device: List[dict] = []
    for e in spans:
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat == "user_annotation" and name.startswith(PREFIX):
            ts, dur = when(e)
            ranges[name].append((ts, ts + dur))
        elif cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch_at[int(e["args"]["correlation"])] = when(e)[0]
        elif cat in DEVICE_CATS:
            device.append(e)
    if WINDOW not in ranges:
        raise RuntimeError("the trace holds no bench/window range")
    w0, w1 = ranges[WINDOW][0]
    host = [(s, e, n) for n, rs in ranges.items() for s, e in rs]

    active, found = [], []
    for e in device:
        ts, dur = when(e)
        if ts + dur < w0 or ts > w1:
            continue
        active.append((max(ts, w0), min(ts + dur, w1)))
        if e.get("cat") == "kernel":
            found.append((e.get("name", "?"), ts, dur, launch_at.get(int(e.get("args", {}).get("correlation", -1)))))
    busy = _union(active)
    gap_spans, edge = [], w0
    for s, e in busy + [(w1, w1)]:
        if s > edge:
            gap_spans.append((edge, s))
        edge = max(edge, e)
    launched = [t for *_, t in found if t is not None]
    stacks = iter(_stacks(host, launched + [(a + b) / 2 for a, b in gap_spans]))
    kernels = [Kernel(n, dur, next(stacks) if t is not None else ()) for n, _, dur, t in found]
    gaps = []
    for a, b in gap_spans:
        inner = [r for r in next(stacks) if r != WINDOW]
        gaps.append((b - a, inner[0][len(PREFIX):] if inner else "window"))
    return TraceSummary(window=(w0, w1), busy_s=sum(e - s for s, e in busy), kernels=kernels, gaps=gaps)


def profile(fn: Callable[[], object]) -> Tuple[object, TraceSummary]:
    """Run `fn` inside a `bench/window` range under the profiler; return its
    result and the trace's summary. `fn` must end with the device idle
    (a synchronising fetch).

    The profiler records only `record_function` ranges on the host (not
    every aten op, which slows the host several times over) and all device
    activity. That takes torch's private profiler entry points; where they
    differ in this torch, the run raises rather than read a trace of
    another kind under the same metric names."""
    from torch._C._profiler import ProfilerConfig, ProfilerState, RecordScope, _ExperimentalConfig
    from torch.autograd import _disable_profiler, _enable_profiler, _prepare_profiler
    from torch.profiler import ProfilerActivity

    activities = {ProfilerActivity.CPU}
    if torch.cuda.is_available():
        activities.add(ProfilerActivity.CUDA)
    config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False, _ExperimentalConfig())
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        _prepare_profiler(config, activities)
        _enable_profiler(config, activities, {RecordScope.USER_SCOPE})
        with torch.profiler.record_function(WINDOW):
            out = fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        _disable_profiler().save(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return out, summarize(events)
