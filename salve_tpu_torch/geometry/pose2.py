"""Minimal SE(2) pose type for the graph back-end.

Replaces the gtsam.Pose2 objects threaded through the reference's Stage D
(salve/algorithms/pose2_slam.py). Angles in radians.

A copy of salve_tpu/geometry/pose2.py (no JAX).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np


class Pose2(NamedTuple):
    """SE(2) pose (x, y, theta)."""

    x: float
    y: float
    theta: float

    # -- accessors (gtsam-compatible names) ---------------------------------
    def translation(self) -> np.ndarray:
        return np.array([self.x, self.y])

    def rotation_matrix(self) -> np.ndarray:
        c, s = math.cos(self.theta), math.sin(self.theta)
        return np.array([[c, -s], [s, c]])

    # -- group ops ----------------------------------------------------------
    def compose(self, other: "Pose2") -> "Pose2":
        c, s = math.cos(self.theta), math.sin(self.theta)
        return Pose2(
            self.x + c * other.x - s * other.y,
            self.y + s * other.x + c * other.y,
            wrap_to_pi(self.theta + other.theta),
        )

    def inverse(self) -> "Pose2":
        c, s = math.cos(self.theta), math.sin(self.theta)
        return Pose2(-(c * self.x + s * self.y), -(-s * self.x + c * self.y), wrap_to_pi(-self.theta))

    def between(self, other: "Pose2") -> "Pose2":
        """Relative pose: self^-1 * other."""
        return self.inverse().compose(other)

    def transform_from(self, p: np.ndarray) -> np.ndarray:
        """Apply pose to local points (N,2) -> world."""
        return p @ self.rotation_matrix().T + self.translation()

    @classmethod
    def from_theta_deg(cls, theta_deg: float, x: float = 0.0, y: float = 0.0) -> "Pose2":
        return cls(x, y, math.radians(theta_deg))

    @classmethod
    def identity(cls) -> "Pose2":
        return cls(0.0, 0.0, 0.0)


def wrap_to_pi(theta: float) -> float:
    """Wrap an angle to (-pi, pi]."""
    return float(np.arctan2(np.sin(theta), np.cos(theta)))
