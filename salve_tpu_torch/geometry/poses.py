"""Minimal SE(3)/Sim(3) pose types (NumPy), replacing GTSAM Pose3/Similarity3.

The pipeline's poses are planar (z-rotations, z=0 translations) lifted to 3D
only for evaluation parity with the reference, so these types carry plain
arrays and a handful of closed-form ops — no manifold optimizers needed here
(the reference's Pose(2) solver is salve_tpu/algorithms/pose2_slam.py).

A copy of salve_tpu/geometry/poses.py (no JAX).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Pose3(NamedTuple):
    """Rigid 3D pose wTc = (R, t): p_w = R p_c + t."""

    R: np.ndarray  # (3,3)
    t: np.ndarray  # (3,)

    def rotation(self) -> np.ndarray:
        return self.R

    def translation(self) -> np.ndarray:
        return self.t

    def compose(self, other: "Pose3") -> "Pose3":
        return Pose3(self.R @ other.R, self.R @ other.t + self.t)

    def inverse(self) -> "Pose3":
        Rt = self.R.T
        return Pose3(Rt, -Rt @ self.t)

    @classmethod
    def from_rot2_trans2(cls, R2: np.ndarray, t2: np.ndarray) -> "Pose3":
        """Lift a planar pose to 3D (rotation about +z, z=0 translation)."""
        R3 = np.eye(3)
        R3[:2, :2] = R2
        return cls(R3, np.array([t2[0], t2[1], 0.0]))


class Sim3(NamedTuple):
    """Similarity 3D transform aSb: p_a = s * (R p_b + t) — GTSAM convention."""

    R: np.ndarray  # (3,3)
    t: np.ndarray  # (3,)
    s: float

    def transform_point(self, p: np.ndarray) -> np.ndarray:
        return self.s * (self.R @ p + self.t)

    def transform_pose(self, bTc: Pose3) -> Pose3:
        """Act on a pose: aTc = (aRb bRc, s(aRb btc + atb)) — matches Similarity3::transformFrom."""
        return Pose3(self.R @ bTc.R, self.s * (self.R @ bTc.t + self.t))

    @classmethod
    def identity(cls) -> "Sim3":
        return cls(np.eye(3), np.zeros(3), 1.0)


def rotation_angle_deg(R1: np.ndarray, R2: np.ndarray) -> float:
    """Geodesic angle (degrees) between two 3D rotations."""
    Rrel = R1.T @ R2
    cos_angle = np.clip((np.trace(Rrel) - 1.0) / 2.0, -1.0, 1.0)
    return float(np.rad2deg(np.arccos(cos_angle)))
