"""Align predicted cluster poses with the GT floor map (for stitch eval).

Parity: salve/stitching/ground_truth_utils.py:35 — SE(2) alignment anchored
at the cluster's start pano: both pose sets are brought into registration
by making the start pano's predicted pose coincide with its GT pose.

A copy of salve_tpu/stitching/ground_truth_utils.py (no JAX).
"""

from __future__ import annotations

import math
from copy import deepcopy
from typing import Any, Dict


def align_pred_poses_with_gt(floor_map_gt_object: Any, cluster: Dict) -> Dict:
    """Anchor the cluster's predicted poses to GT at the start pano."""
    cluster_gt = {}
    for panoid in cluster["panos"]:
        pose_gt = floor_map_gt_object.get_pano_global_pose(panoid)
        if pose_gt:
            cluster_gt[panoid] = pose_gt

    new_cluster = deepcopy(cluster)

    start_panoid = cluster["start_panoid"]
    pose_gt = cluster_gt[start_panoid]
    pose_pred = cluster["panos"][start_panoid]["pose"]
    translation1 = [-pose_pred["x"], -pose_pred["y"]]
    rotation2 = -(pose_gt.rotation - pose_pred["rotation"]) * math.pi / 180
    translation3 = [pose_gt.position.x, pose_gt.position.y]

    new_cluster["panos"] = {}
    for panoid_1 in cluster["panos"]:
        pose1 = cluster["panos"][panoid_1]["pose"]
        x1 = pose1["x"] + translation1[0]
        y1 = pose1["y"] + translation1[1]
        x2 = math.cos(rotation2) * x1 - math.sin(rotation2) * y1
        y2 = math.sin(rotation2) * x1 + math.cos(rotation2) * y1
        new_cluster["panos"][panoid_1] = {
            "pose": {
                "x": x2 + translation3[0],
                "y": y2 + translation3[1],
                "rotation": pose1["rotation"] + (pose_gt.rotation - pose_pred["rotation"]),
            }
        }
    return new_cluster
