"""Room layouts made from the seed, as a layout detector hands them in.

The benchmark's own copy of the law of the port's seeded MHNet predictions
(salve_tpu_torch/dataset/seeded_predictions.py:write_seeded_mhnet_predictions)
and of the parser that turns one into a pano's layout
(salve_tpu_torch/dataset/mhnet_prediction.py:convert_to_pano_data, with its
projection and RDP helpers), drawn for a pool of panos at once:

* the floor boundary is 1024 columns of 330 + 40 sin(k u + phi) rows, k in
  1-3 and phi in [0, 6), plus N(0, 2) rows of noise; the room is the
  boundary rounded to whole rows, backprojected onto the floor of a camera
  at height 1 and simplified by Ramer-Douglas-Peucker at 0.02, which leaves
  some 540-610 vertices a room;
* 0-3 spans of each W/D/O type, each starting uniform in [0.02, 0.9] of the
  width and 0.02-0.08 wide, and in 30% of the panos an opening split by the
  seam, which the parser merges into one; each span's endpoints are the
  boundary's (unrounded) rows at its ends, backprojected the same way.

A layout is the room's (V, 2) float64 vertices and its W/D/Os in paint
order (doors, windows, openings, as `PanoData.all_wdos` lists them), each
(type, pt1, pt2). Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import numpy as np

WIDTH = 1024
CAMERA_HEIGHT_M = 1.0
RDP_EPSILON = 0.02
PAINT_ORDER = ("doors", "windows", "openings")
KINDS = {"door": "doors", "window": "windows", "opening": "openings"}


class Layout(NamedTuple):
    room: np.ndarray  # (V, 2) float64
    wdos: List[Tuple[str, Tuple[float, float], Tuple[float, float]]]  # (type, pt1, pt2) in paint order


def pixel_to_floor(points_px: np.ndarray) -> np.ndarray:
    """(N, 2) pano pixels (column, row) of floor points -> (N, 2) metres on
    the floor, for a camera at CAMERA_HEIGHT_M (geometry/pano_projection.py's
    chain: sphere, room-Cartesian, the floor plane, right-handed axes)."""
    height = WIDTH / 2
    x = points_px[..., 0]
    y = np.clip(points_px[..., 1], 0, height - 1)
    theta = x / (WIDTH - 1) * (2.0 * math.pi) - math.pi
    phi = np.clip((1.0 - y / (height - 1)) * math.pi - math.pi / 2.0, -math.pi / 2, math.pi / 2)
    rho_cos_phi = np.cos(phi)
    cart = np.stack([rho_cos_phi * np.sin(theta), np.sin(phi), rho_cos_phi * np.cos(theta)], axis=-1)
    flipped = cart * np.asarray([1.0, 1.0, -1.0])
    world = flipped / flipped[..., 1:2] * CAMERA_HEIGHT_M
    return np.stack([-world[..., 0], world[..., 2]], axis=-1)


def rdp(points: np.ndarray, epsilon: float) -> np.ndarray:
    """Ramer-Douglas-Peucker: the points of an (N, 2) polyline that deviate
    more than `epsilon` from the chord of their span, with both ends."""
    n = len(points)
    if n < 3:
        return points.copy()
    keep = np.zeros(n, dtype=bool)
    keep[0] = keep[-1] = True
    stack = [(0, n - 1)]
    while stack:
        lo, hi = stack.pop()
        if hi <= lo + 1:
            continue
        d = points[hi] - points[lo]
        rel = points[lo + 1 : hi] - points[lo]
        norm = np.linalg.norm(d)
        dists = np.linalg.norm(rel, axis=1) if norm == 0 else np.abs(d[0] * rel[:, 1] - d[1] * rel[:, 0]) / norm
        idx = int(np.argmax(dists))
        if dists[idx] > epsilon:
            split = lo + 1 + idx
            keep[split] = True
            stack += [(lo, split), (split, hi)]
    return points[keep]


def merge_seam(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """A span starting within 1% of the left edge and one ending within 1% of
    the right are one object split by the seam: one span from the right
    piece's start to the left piece's end, put last."""
    if len(spans) <= 1:
        return spans
    left = [s < 0.01 for s, _ in spans]
    right = [e > 0.99 for _, e in spans]
    if not (any(left) and any(right)):
        return spans
    li, ri = left.index(True), right.index(True)
    return [w for i, w in enumerate(spans) if i not in (li, ri)] + [(spans[ri][0], spans[li][1])]


def draw_layout(rng: np.random.Generator) -> Layout:
    u = np.linspace(0, 2 * np.pi, WIDTH)
    boundary = 330 + 40 * np.sin(u * rng.integers(1, 4) + rng.uniform(0, 6)) + rng.normal(0, 2, WIDTH)
    spans = {}
    for kind in KINDS:
        spans[kind] = []
        for _ in range(rng.integers(0, 4)):
            s = rng.uniform(0.02, 0.9)
            spans[kind].append((s, s + rng.uniform(0.02, 0.08)))
    if rng.uniform() < 0.3:
        spans["opening"] += [(0.001, 0.04), (0.96, 1.0)]
    px = np.stack([np.arange(WIDTH), np.round(boundary)], axis=-1).astype(np.float64)
    room = rdp(pixel_to_floor(px), RDP_EPSILON)
    by_type = {t: [] for t in PAINT_ORDER}
    for kind, t in KINDS.items():
        for s, e in merge_seam(spans[kind]):
            s_u, e_u = float(np.clip(s * WIDTH, 0, WIDTH - 1)), float(np.clip(e * WIDTH, 0, WIDTH - 1))
            ends = pixel_to_floor(np.array([[s_u, boundary[round(s_u)]], [e_u, boundary[round(e_u)]]]))
            by_type[t].append((t, (ends[0, 0], ends[0, 1]), (ends[1, 0], ends[1, 1])))
    return Layout(room, [w for t in PAINT_ORDER for w in by_type[t]])


def layout_pool(num_panos: int, seed: int) -> List[Layout]:
    """The layout of each pano of the pool (synthetic.pano_pool's panos)."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 41]))
    return [draw_layout(rng) for _ in range(num_panos)]


def describe(pool: List[Layout]) -> str:
    verts = [len(x.room) for x in pool]
    wdos = [len(x.wdos) for x in pool]
    return (f"layouts of {len(pool)} panos: {min(verts)}-{max(verts)} room vertices (median "
            f"{float(np.median(verts))}), {min(wdos)}-{max(wdos)} W/D/Os a pano ({sum(wdos)} in all)")
