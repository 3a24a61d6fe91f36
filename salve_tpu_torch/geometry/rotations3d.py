"""3D rotation constructors (replacing gtsam.Rot3 conversions).

A copy of salve_tpu/geometry/rotations3d.py (no JAX).
"""

from __future__ import annotations

import numpy as np


def axis_angle_to_matrix(r: np.ndarray) -> np.ndarray:
    """Axis-angle vector (angle = |r|) -> (3,3) rotation (Rodrigues)."""
    r = np.asarray(r, dtype=np.float64).reshape(3)
    n = np.linalg.norm(r)
    if n < 1e-15:
        return np.eye(3)
    axis = r / n
    K = np.array(
        [
            [0, -axis[2], axis[1]],
            [axis[2], 0, -axis[0]],
            [-axis[1], axis[0], 0],
        ]
    )
    return np.eye(3) + np.sin(n) * K + (1 - np.cos(n)) * (K @ K)


def matrix_to_axis_angle(R: np.ndarray) -> np.ndarray:
    """(3,3) rotation -> axis-angle vector."""
    cos_angle = np.clip((np.trace(R) - 1) / 2, -1.0, 1.0)
    angle = np.arccos(cos_angle)
    if angle < 1e-12:
        return np.zeros(3)
    axis = (
        np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
        / (2 * np.sin(angle))
    )
    return axis * angle


def rot3_rzryrx(rx: float, ry: float, rz: float) -> np.ndarray:
    """Rz(rz) @ Ry(ry) @ Rx(rx) — GTSAM Rot3.RzRyRx convention."""
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx
