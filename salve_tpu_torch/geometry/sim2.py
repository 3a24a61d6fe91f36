"""Similarity(2) transformation: the part of salve_tpu/geometry/sim2.py the
fused scoring path uses (a numpy copy; the port imports nothing of
salve_tpu).

JSON wire format {"R": [4 floats row-major], "t": [2], "s": float}; action on
a point p_out = s * (R @ p + t).
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

    @property
    def rotation(self) -> np.ndarray:
        return self.R_

    @property
    def translation(self) -> np.ndarray:
        return self.t_

    @property
    def scale(self) -> float:
        return self.s_

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
    def from_theta_deg(cls, theta_deg: float, t: np.ndarray, s: float = 1.0) -> "Sim2":
        th = np.deg2rad(theta_deg)
        c, sn = np.cos(th), np.sin(th)
        return cls(R=np.array([[c, -sn], [sn, c]]), t=np.asarray(t, dtype=np.float64), s=s)
