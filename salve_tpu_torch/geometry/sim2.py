"""Similarity(2) transformation (a numpy copy of salve_tpu/geometry/sim2.py).

Host-side class API mirrors the reference (salve/common/sim2.py) including
its JSON wire format {"R": [4 floats row-major], "t": [2], "s": float} and
its group conventions:

    action on a point:  p_out = s * (R @ p + t)
    3x3 matrix form:    [[R, t], [0, 1/s]]
    compose(A, B):      (R_A R_B,  R_A t_B + t_A / s_B,  s_A s_B)
    inverse:            (R^T,  -R^T (s t),  1/s)

R_ and t_ are stored as float32: the hypothesis JSON bytes depend on it.
Batched tensor equivalents over stacked parameters live in
`salve_tpu_torch.geometry.sim2_batch`.
"""

from __future__ import annotations

import json
import os
from typing import Union

import numpy as np

_PathLike = Union[str, "os.PathLike[str]"]


class Sim2:
    """Similarity(2) group element, parameterized by (R, t, s)."""

    __slots__ = ("R_", "t_", "s_")

    def __init__(self, R: np.ndarray, t: np.ndarray, s: Union[int, float]) -> None:
        R = np.asarray(R)
        t = np.asarray(t)
        if R.shape != (2, 2):
            raise ValueError("Rotation must have shape (2,2).")
        if t.shape != (2,):
            raise ValueError("Translation must have shape (2,).")
        s = float(s)
        if np.isclose(s, 0.0):
            raise ZeroDivisionError("Sim(2) with zero scale has no 3x3 matrix form.")
        self.R_ = R.astype(np.float32)
        self.t_ = t.astype(np.float32)
        self.s_ = s

    # -- properties ----------------------------------------------------------
    @property
    def rotation(self) -> np.ndarray:
        return self.R_

    @property
    def translation(self) -> np.ndarray:
        return self.t_

    @property
    def scale(self) -> float:
        return self.s_

    @property
    def theta_deg(self) -> float:
        """Rotation angle in degrees, from the (cos, sin) in R's first column."""
        c, s = self.R_[0, 0], self.R_[1, 0]
        return float(np.rad2deg(np.arctan2(s, c)))

    @property
    def matrix(self) -> np.ndarray:
        """3x3 homogeneous matrix [[R, t], [0, 1/s]]."""
        T = np.zeros((3, 3))
        T[:2, :2] = self.R_
        T[:2, 2] = self.t_
        T[2, 2] = 1 / self.s_
        return T

    # -- dunder --------------------------------------------------------------
    def __repr__(self) -> str:
        return f"Angle (deg.): {self.theta_deg:.1f}, Trans.: {np.round(self.t_, 2)}, Scale: {self.s_:.1f}"

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Sim2):
            return False
        return (
            np.isclose(self.s_, other.s_)
            and np.allclose(self.R_, other.R_)
            and np.allclose(self.t_, other.t_)
        )

    def __hash__(self) -> int:
        return hash((self.R_.tobytes(), self.t_.tobytes(), self.s_))

    # -- group operations ----------------------------------------------------
    def compose(self, S: "Sim2") -> "Sim2":
        """Group composition: equivalent to multiplying the 3x3 matrix forms."""
        return Sim2(
            R=self.R_ @ S.R_,
            t=self.R_ @ S.t_ + (1.0 / S.s_) * self.t_,
            s=self.s_ * S.s_,
        )

    def inverse(self) -> "Sim2":
        Rt = self.R_.T
        return Sim2(Rt, -Rt @ (self.s_ * self.t_), 1.0 / self.s_)

    def transform_from(self, point_cloud: np.ndarray) -> np.ndarray:
        """Apply the transformation to points (N,2): p_out = s*(R p + t)."""
        point_cloud = np.asarray(point_cloud)
        if point_cloud.ndim != 2 or point_cloud.shape[1] != 2:
            raise ValueError("Input points must have shape (N,2).")
        return (point_cloud @ self.R_.T + self.t_) * self.s_

    def transform_point_cloud(self, point_cloud: np.ndarray) -> np.ndarray:
        """Alias for transform_from, for API symmetry with SE(2)/SE(3)."""
        return self.transform_from(point_cloud)

    # -- serialization (wire-compatible with the reference) -------------------
    def save_as_json(self, save_fpath: _PathLike) -> None:
        obj = {
            "R": self.R_.flatten().tolist(),
            "t": self.t_.flatten().tolist(),
            "s": self.s_,
        }
        os.makedirs(os.path.dirname(str(save_fpath)) or ".", exist_ok=True)
        with open(save_fpath, "w") as f:
            json.dump(obj, f)

    @classmethod
    def from_json(cls, json_fpath: _PathLike) -> "Sim2":
        with open(json_fpath, "r") as f:
            data = json.load(f)
        return cls(
            R=np.array(data["R"]).reshape(2, 2),
            t=np.array(data["t"]).reshape(2),
            s=float(data["s"]),
        )

    @classmethod
    def from_matrix(cls, T: np.ndarray) -> "Sim2":
        if np.isclose(T[2, 2], 0.0):
            raise ZeroDivisionError("Sim(2) scale would require division by zero.")
        return cls(R=T[:2, :2], t=T[:2, 2], s=1 / T[2, 2])

    @classmethod
    def identity(cls) -> "Sim2":
        return cls(R=np.eye(2), t=np.zeros(2), s=1.0)

    @classmethod
    def from_theta_deg(cls, theta_deg: float, t: np.ndarray, s: float = 1.0) -> "Sim2":
        th = np.deg2rad(theta_deg)
        c, sn = np.cos(th), np.sin(th)
        return cls(R=np.array([[c, -sn], [sn, c]]), t=np.asarray(t, dtype=np.float64), s=s)
