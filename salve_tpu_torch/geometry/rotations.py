"""2D rotation helpers (host-side NumPy).

Parity target: salve/utils/rotation_utils.py in the reference (which wraps
GTSAM Rot3 for the 2x2->3x3 lift; here it is a plain NumPy embed).

A copy of salve_tpu/geometry/rotations.py (no JAX).
"""

from __future__ import annotations

import numpy as np


def rotmat2d(theta_deg: float) -> np.ndarray:
    """Return the 2x2 rotation matrix for an angle given in degrees."""
    theta_rad = np.deg2rad(theta_deg)
    s, c = np.sin(theta_rad), np.cos(theta_rad)
    return np.array([[c, -s], [s, c]])


def rotmat2theta_deg(R: np.ndarray) -> float:
    """Recover the rotation angle (degrees) from a 2x2 rotation matrix.

    The first column of R holds (cos, sin) of theta.
    """
    c, s = R[0, 0], R[1, 0]
    return float(np.rad2deg(np.arctan2(s, c)))


def rot2x2_to_3x3(R: np.ndarray) -> np.ndarray:
    """Embed a 2x2 rotation into a 3x3 rotation about the +z axis."""
    R3 = np.eye(3)
    R3[:2, :2] = R
    return R3


def wrap_angle_deg(angle1: float, angle2: float) -> float:
    """Minimum angular difference between two angles (degrees), wrapping at 360."""
    diff = (angle2 - angle1 + 180) % 360 - 180
    if diff < -180:
        return float(np.absolute(diff + 360))
    return float(np.absolute(diff))


def angle_is_equal(angle1: float, angle2: float, atol: float) -> bool:
    """Whether the shortest angular distance between two angles is within `atol` degrees."""
    diff = (angle2 - angle1 + 180) % 360 - 180
    if diff < -180:
        diff = diff + 360
    return bool(np.absolute(diff) <= atol)


def rotate_polygon_about_pt(pts: np.ndarray, rotmat: np.ndarray, center_pt: np.ndarray) -> np.ndarray:
    """Rotate a polygon/point cloud (N,d) about `center_pt` by `rotmat` (d,d)."""
    return (pts - center_pt) @ rotmat.T + center_pt
