"""Ramer-Douglas-Peucker polyline simplification (replaces the `rdp` C lib).

A copy of salve_tpu/geometry/simplify.py (no JAX).
"""

from __future__ import annotations

import numpy as np


def _perpendicular_distances(points: np.ndarray, start: np.ndarray, end: np.ndarray) -> np.ndarray:
    """Distance from each point to the line through (start, end)."""
    d = end - start
    norm = np.linalg.norm(d)
    if norm == 0:
        return np.linalg.norm(points - start, axis=1)
    # 2D cross-product magnitude / segment length.
    rel = points - start
    return np.abs(d[0] * rel[:, 1] - d[1] * rel[:, 0]) / norm


def rdp(points: np.ndarray, epsilon: float) -> np.ndarray:
    """Simplify an (N,2) polyline, keeping points deviating more than epsilon.

    Iterative stack formulation of the classic recursive algorithm; output
    matches the `rdp` package for the same epsilon.
    """
    points = np.asarray(points, dtype=np.float64)
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
        seg = points[lo + 1 : hi]
        dists = _perpendicular_distances(seg, points[lo], points[hi])
        idx = int(np.argmax(dists))
        if dists[idx] > epsilon:
            split = lo + 1 + idx
            keep[split] = True
            stack.append((lo, split))
            stack.append((split, hi))
    return points[keep]
