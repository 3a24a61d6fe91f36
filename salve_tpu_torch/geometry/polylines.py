"""Polyline resampling (chordal arc-length parameterization).

Parity target: salve/utils/polyline_interpolation.py. Host-side NumPy.

A copy of salve_tpu/geometry/polylines.py (no JAX).
"""

from __future__ import annotations

import numpy as np


def get_polyline_length(polyline: np.ndarray) -> float:
    """Total chord length of an (N,2) polyline."""
    assert polyline.shape[1] == 2
    return float(np.linalg.norm(np.diff(polyline, axis=0), axis=1).sum())


def interp_evenly_spaced_points(polyline: np.ndarray, interval_m: float) -> np.ndarray:
    """Resample an (N,2) polyline to one waypoint every `interval_m` (ceil count)."""
    length_m = get_polyline_length(polyline)
    n_waypoints = int(np.ceil(length_m / interval_m))
    consecutive_dists = np.linalg.norm(np.diff(polyline, axis=0), axis=1)
    if np.any(consecutive_dists == 0):
        raise ValueError("Duplicate consecutive waypoints found in polyline.")
    return interp_arc(t=n_waypoints, points=polyline)


def interp_arc(t: int, points: np.ndarray) -> np.ndarray:
    """Interpolate `t` equally-spaced (by chordal arclength) points along a polyline.

    Args:
        t: number of output points.
        points: (N,2) or (N,3) polyline vertices.

    Returns:
        (t, d) resampled points.
    """
    if points.ndim != 2:
        raise ValueError("Input array must be (N,2) or (N,3) in shape.")
    n, _ = points.shape
    eq_spaced = np.linspace(0, 1, t)
    chordlen = np.linalg.norm(np.diff(points, axis=0), axis=1)
    chordlen = chordlen / np.sum(chordlen)
    cumarc = np.zeros(len(chordlen) + 1)
    cumarc[1:] = np.cumsum(chordlen)
    tbins = np.digitize(eq_spaced, bins=cumarc).astype(int)
    tbins[(tbins <= 0) | (eq_spaced <= 0)] = 1
    tbins[(tbins >= n) | (eq_spaced >= 1)] = n - 1
    frac = (eq_spaced - cumarc[tbins - 1]) / chordlen[tbins - 1]
    anchors = points[tbins - 1, :]
    offsets = (points[tbins, :] - points[tbins - 1, :]) * frac.reshape(-1, 1)
    return anchors + offsets
