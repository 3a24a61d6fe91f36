"""3D pose graph + projection to 2D (parity: salve/common/posegraph3d.py).

A copy of salve_tpu/common/posegraph3d.py (no JAX).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from salve_tpu_torch.common.posegraph2d import PoseGraph2d
from salve_tpu_torch.geometry.poses import Pose3
from salve_tpu_torch.geometry.sim2 import Sim2


@dataclass
class PoseGraph3d:
    """3D pose graph for one floor of a ZInD building."""

    building_id: str
    floor_id: str
    pose_dict: Dict[int, Pose3]

    def project_to_2d(self, gt_floor_pose_graph: PoseGraph2d) -> PoseGraph2d:
        """Drop to the plane, borrowing per-pano metadata from the GT graph."""
        nodes = {}
        for i, wTi in self.pose_dict.items():
            if i not in gt_floor_pose_graph.nodes:
                continue
            pd = copy.deepcopy(gt_floor_pose_graph.nodes[i])
            R2 = wTi.R[:2, :2]
            # Snap the projected 2x2 block back onto SO(2).
            theta = np.arctan2(R2[1, 0], R2[0, 0])
            c, s = np.cos(theta), np.sin(theta)
            pd.global_Sim2_local = Sim2(
                R=np.array([[c, -s], [s, c]]), t=wTi.t[:2], s=1.0
            )
            nodes[i] = pd
        return PoseGraph2d(
            building_id=self.building_id,
            floor_id=self.floor_id,
            nodes=nodes,
            scale_meters_per_coordinate=gt_floor_pose_graph.scale_meters_per_coordinate,
        )

    @classmethod
    def from_wTi_list(
        cls, wTi_list: List[Optional[Pose3]], building_id: str, floor_id: str
    ) -> "PoseGraph3d":
        return cls(
            building_id=building_id,
            floor_id=floor_id,
            pose_dict={i: wTi for i, wTi in enumerate(wTi_list) if wTi is not None},
        )
