"""Window / Door / Opening (W/D/O) primitive.

A W/D/O is a vertical quad on a room wall, parameterized by its two 2D
endpoints in the pano's ego-normalized frame plus bottom/top heights.
Parity: salve/common/wdo.py (including the ZInD left-handed -> right-handed
x-flip applied when parsing raw annotation triplets).

A copy of salve_tpu/common/wdo.py (no JAX).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Tuple

import numpy as np

from salve_tpu_torch.geometry.sim2 import Sim2


@dataclass
class WDO:
    """One window, door, or opening.

    Attributes:
        global_Sim2_local: pose of the host panorama (world <- local).
        pt1, pt2: left/right endpoints (x, y) in the pano's local frame.
        bottom_z, top_z: base and top heights.
        type: "windows" | "doors" | "openings".
    """

    global_Sim2_local: Sim2
    pt1: Tuple[float, float]
    pt2: Tuple[float, float]
    bottom_z: float
    top_z: float
    type: str

    @property
    def centroid(self) -> np.ndarray:
        return np.array([self.pt1, self.pt2]).mean(axis=0)

    @property
    def width(self) -> float:
        """Length of the pt1-pt2 segment."""
        return float(np.linalg.norm(np.array(self.pt1) - np.array(self.pt2)))

    @property
    def vertices_local_2d(self) -> np.ndarray:
        return np.array([self.pt1, self.pt2])

    @property
    def vertices_global_2d(self) -> np.ndarray:
        return self.global_Sim2_local.transform_from(self.vertices_local_2d)

    @property
    def vertices_local_3d(self) -> np.ndarray:
        (x1, y1), (x2, y2) = self.pt1, self.pt2
        return np.array([[x1, y1, self.bottom_z], [x2, y2, self.top_z]])

    @property
    def polygon_vertices_local_3d(self) -> np.ndarray:
        """Closed 3D quad outline (first vertex repeated last).

        Note the vertex multiplicity — pt1 appears 3x and pt2 2x. The SE(2)/
        Sim(3) fits in Stage A consume these 5 points verbatim, so the fit is
        (intentionally, for parity) weighted slightly toward pt1.
        """
        (x1, y1), (x2, y2) = self.pt1, self.pt2
        return np.array(
            [
                [x1, y1, self.bottom_z],
                [x1, y1, self.top_z],
                [x2, y2, self.top_z],
                [x2, y2, self.bottom_z],
                [x1, y1, self.bottom_z],
            ]
        )

    def get_wd_normal_2d(self) -> np.ndarray:
        """Unit normal to the W/D/O segment (CCW rotation of pt1->pt2)."""
        v = np.array(self.pt2) - np.array(self.pt1)
        n = np.array([-v[1], v[0]])
        return n / np.linalg.norm(n)

    def get_rotated_version(self) -> "WDO":
        """The W/D/O as seen from the other side of the doorway (endpoints swapped)."""
        return WDO(
            global_Sim2_local=self.global_Sim2_local,
            pt1=self.pt2,
            pt2=self.pt1,
            bottom_z=self.bottom_z,
            top_z=self.top_z,
            type=self.type,
        )

    def transform_from(self, i2Ti1: Sim2) -> "WDO":
        """Move this W/D/O from frame i1 into frame i2."""
        pt1_ = tuple(i2Ti1.transform_from(np.array(self.pt1).reshape(1, 2)).squeeze().tolist())
        pt2_ = tuple(i2Ti1.transform_from(np.array(self.pt2).reshape(1, 2)).squeeze().tolist())
        return WDO(
            global_Sim2_local=self.global_Sim2_local.compose(i2Ti1.inverse()),
            pt1=pt1_,
            pt2=pt2_,
            bottom_z=self.bottom_z,
            top_z=self.top_z,
            type=self.type,
        )

    def apply_Sim2(self, a_Sim2_b: Sim2, gt_scale: float) -> "WDO":
        """Re-express the host pano pose in a new global frame `a` (for Sim(3) eval alignment)."""
        out = copy.deepcopy(self)
        a_Sim2_j = a_Sim2_b.compose(self.global_Sim2_local)
        out.global_Sim2_local = Sim2(
            R=a_Sim2_j.rotation, t=a_Sim2_j.translation * a_Sim2_j.scale, s=gt_scale
        )
        return out

    @classmethod
    def from_object_array(cls, wdo_data: Any, global_Sim2_local: Sim2, type: str) -> "WDO":
        """Parse one raw ZInD annotation triplet [(x1,y1),(x2,y2),(bottom_z,top_z)].

        ZInD stores a left-handed frame; x is negated here for the
        right-handed world frame (see COORDINATE_FRAMES.md in the reference).
        """
        pt1 = list(wdo_data[0])
        pt2 = list(wdo_data[1])
        bottom_z, top_z = wdo_data[2]
        pt1[0] *= -1
        pt2[0] *= -1
        return cls(
            global_Sim2_local=global_Sim2_local,
            pt1=tuple(pt1),
            pt2=tuple(pt2),
            bottom_z=float(bottom_z),
            top_z=float(top_z),
            type=type,
        )
