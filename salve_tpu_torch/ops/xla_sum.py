"""float32 sums added in the order of XLA:CPU's compiled reduction loops.

A float32 sum's bits depend on the order of its adds. XLA:CPU emits each
reduction as a loop that LLVM may vectorize: `vf` lanes (times `ic`
interleaved accumulators) each add every (vf * ic)-th element, the lanes are
folded by halving (lane l + lane l + vf/2, ...), and the rest is added one
by one, or by a narrower vector epilogue that starts from the running sum in
its lane 0. Reductions longer than 32 are first cut into windows of 32 (XLA's
tree-reduction rewrite, padding with zeros), each window reduced as above,
then the window sums reduced.

A plan says which: `{"stages": [[vf, ic, count], ...]}` covers the first
elements stage by stage and adds the rest in index order (`{"stages": []}`
is a plain loop); a stage `[vf, 2, count, 1]` is the form in which the code
generator has folded the second accumulator's FMA chain into the first
(`_merged_stage`); `{"window": 32, "pad": [left, right], "inner": [...],
"outer": [...]}` is the windowed form. The plans that the JAX package's
compiled RANSAC scorer uses for each pose count are measured by
`derive_xla_sum_orders.py` and kept in `xla_sum_orders.json` up to 32
poses; past 32 every sum takes the windowed form (`windowed`), which the
script checked up to the pose count the file records.
"""

from __future__ import annotations

import functools
import json
import pathlib
from typing import Optional

import torch
import torch.nn.functional as F

SEQUENTIAL = {"stages": []}


def _stages(x: torch.Tensor, stages) -> torch.Tensor:
    """Reduce the last dim of `x` by the stage list, then index order."""
    n = x.shape[-1]
    acc: Optional[torch.Tensor] = None
    pos = 0
    for stage in stages:
        vf, ic, count = stage[:3]
        if len(stage) > 3 and stage[3]:
            acc = _merged_stage(x[..., pos : pos + count], vf, acc)
            pos += count
            continue
        lanes = [None] * (vf * ic)
        lanes[0] = acc
        for k in range(count):
            v = x[..., pos + k]
            i = k % (vf * ic)
            if lanes[i] is None:
                # Lane 0 starts from the reduction's +0 init, the others
                # from -0: only the sign of an all-zero sum shows it.
                lanes[i] = v + 0.0 if i == 0 else v
            else:
                lanes[i] = lanes[i] + v
        vec = lanes[:vf]
        for c in range(1, ic):
            vec = [vec[l] + lanes[c * vf + l] for l in range(vf)]
        while len(vec) > 1:
            half = len(vec) // 2
            vec = [vec[l] + vec[l + half] for l in range(half)]
        acc = vec[0]
        pos += count
    for k in range(pos, n):
        acc = x[..., k] + 0.0 if acc is None else acc + x[..., k]
    if acc is None:
        acc = torch.zeros_like(x[..., 0]) if n else x.new_zeros(x.shape[:-1])
    return acc


def _merged_stage(x: torch.Tensor, vf: int, acc: Optional[torch.Tensor]) -> torch.Tensor:
    """Two interleaved accumulators whose second one the code generator
    folds into the first: each lane runs through part 0 of every step in
    order, then part 1 of step 1, step 0, step 2, ... (the FMA chain of part
    1 is rooted at its step-1 product), then the lanes halve as usual."""
    steps = x.shape[-1] // (2 * vf)
    order = [1, 0, *range(2, steps)] if steps > 1 else [0]
    vec = []
    for l in range(vf):
        lane = acc if l == 0 else None
        for j in range(steps):
            v = x[..., 2 * vf * j + l]
            lane = (v + 0.0 if l == 0 else v) if lane is None else lane + v
        for j in order:
            lane = lane + x[..., 2 * vf * j + vf + l]
        vec.append(lane)
    while len(vec) > 1:
        half = len(vec) // 2
        vec = [vec[l] + vec[l + half] for l in range(half)]
    return vec[0]


def ordered_sum(x: torch.Tensor, dim: int = -1, plan: Optional[dict] = None) -> torch.Tensor:
    """Sum `x` over `dim` in the order `plan` describes (None: index order)."""
    x = torch.movedim(x, dim, -1)
    plan = SEQUENTIAL if plan is None else plan
    if "window" in plan:
        width = plan["window"]
        left, right = plan["pad"]
        padded = F.pad(x, (left, right))
        windows = padded.reshape(*x.shape[:-1], padded.shape[-1] // width, width)
        return _stages(_stages(windows, plan["inner"]), plan["outer"])
    return _stages(x, plan["stages"])


@functools.lru_cache(maxsize=None)
def _table() -> dict:
    return json.loads(pathlib.Path(__file__).with_name("xla_sum_orders.json").read_text())


def windowed(n: int, width: int = 32) -> dict:
    """XLA's cut of a sum of n > width terms: windows of `width`, the zero
    padding split evenly (the odd one on the right), each window and then
    the window sums added in index order."""
    total = -(-n // width) * width
    left = (total - n) // 2
    return {"window": width, "pad": [left, total - n - left], "inner": [], "outer": []}


RANSAC_SUMS = ("S", "C", "ca", "cb", "den", "num", "rot", "trans")


def ransac_plans(n: int) -> dict:
    """Per-sum plans of the RANSAC scorer at `n` poses: the measured table up
    to 32 poses, the windowed form past it."""
    table = _table()
    if n > table["window_from"] - 1:
        return {name: windowed(n) for name in RANSAC_SUMS}
    return table["ransac_errors"].get(str(n), {})
