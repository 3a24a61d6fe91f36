"""Vanishing-angle / dominant-axis snapping of relative poses.

Parity: salve/utils/axis_alignment_utils.py — refine each relative pose by
the difference of the two panos' vanishing angles (correction capped at
15 degrees), rotating about the W/D/O midpoint. The GTSAM Similarity3.Align
call for re-fitting the corrected pose becomes the closed-form Sim(3) fit
in salve_tpu_torch.geometry.point_alignment.

A copy of salve_tpu/utils/axis_alignment.py (no JAX).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from salve_tpu_torch.common.edgewdopair import EdgeWDOPair
from salve_tpu_torch.common.pano_data import PanoData
from salve_tpu_torch.geometry.point_alignment import align_points_sim3
from salve_tpu_torch.geometry.rotations import (
    rotate_polygon_about_pt,
    rotmat2d,
    rotmat2theta_deg,
)
from salve_tpu_torch.geometry.sim2 import Sim2

# Angles within ~5.7 deg of 90 count as "right angles" (axis_alignment_utils.py:21).
MAX_RIGHT_ANGLE_DEVIATION = 0.1
MAX_ALLOWED_CORRECTION_DEG = 15.0


def compute_relative_angle_deg(v1: np.ndarray, v2: np.ndarray) -> float:
    """Clockwise angle between unit vectors, in [0, 360)."""
    if not np.isclose(np.linalg.norm(v1), 1.0) or not np.isclose(np.linalg.norm(v2), 1.0):
        raise RuntimeError("Must normalize vectors to unit length.")
    init_angle = -np.arctan2(np.linalg.det([v1, v2]), np.dot(v1, v2))
    return float(np.rad2deg(np.mod(init_angle + 2 * np.pi, 2 * np.pi)))


def determine_dominant_rotation_angle(
    poly: np.ndarray,
) -> Tuple[Optional[float], Optional[float]]:
    """Dominant axis angle of a room polygon, in [-45, 45] (parity :25).

    Median x-axis angle of polygon edges that meet a neighbor at ~90 deg.
    """
    POS_X_AXIS_DIR = np.array([1, 0])
    angles = []
    for v_idx in range(poly.shape[0]):
        p1, p2, p3 = (
            poly[(v_idx - 2) % len(poly)],
            poly[(v_idx - 1) % len(poly)],
            poly[v_idx % len(poly)],
        )
        v1 = np.array(p2) - np.array(p1)
        v2 = np.array(p3) - np.array(p2)
        v1 = v1 / np.linalg.norm(v1)
        v2 = v2 / np.linalg.norm(v2)
        if np.abs(v1.dot(v2)) < MAX_RIGHT_ANGLE_DEVIATION:
            angles.append(compute_relative_angle_deg(v1, POS_X_AXIS_DIR))

    if not angles:
        return None, None
    deviations = [ang % 90 for ang in angles]
    angle = float(np.median(deviations))
    if angle > 45:
        angle -= 90
    return angle, len(angles) / len(poly)


def get_dominant_direction_from_point_cloud(point_cloud: np.ndarray) -> float:
    """Dominant axis angle (deg) of a 2D contour / point cloud.

    Parity: axis_alignment_utils.get_dominant_direction_from_point_cloud —
    the angle theta such that rotating the points by rotmat2d(theta) makes
    the dominant edge direction axis-aligned. Computed as the length-weighted
    circular mean of consecutive-edge directions on the 4*theta circle
    (axis directions are 90-deg periodic), mapped to [-45, 45].
    """
    edges = np.diff(np.vstack([point_cloud, point_cloud[:1]]), axis=0)
    lengths = np.linalg.norm(edges, axis=1)
    keep = lengths > 1e-12
    ang4 = 4.0 * np.arctan2(edges[keep, 1], edges[keep, 0])
    w = lengths[keep]
    mean4 = np.arctan2(np.sum(w * np.sin(ang4)), np.sum(w * np.cos(ang4)))
    theta = np.rad2deg(mean4 / 4.0) % 90.0
    if theta > 45.0:
        theta -= 90.0
    return float(theta)


def compute_vp_correction(i2Si1: Sim2, vp_i1: float, vp_i2: float) -> float:
    """Correction i2r_theta_i2 from vanishing angles, mapped to [-45, 45]."""
    i2_theta_i1 = rotmat2theta_deg(i2Si1.rotation)
    i2r_theta_i2 = -((vp_i2 - vp_i1) + i2_theta_i1)
    i2r_theta_i2 = i2r_theta_i2 % 90
    if i2r_theta_i2 > 45:
        i2r_theta_i2 -= 90
    return i2r_theta_i2


def compute_i2Ti1(pts1: np.ndarray, pts2: np.ndarray) -> Sim2:
    """SE(2) relative pose from 2D correspondences via the Sim(3) fit
    projected back to the plane (parity: compute_i2Ti1 at :297)."""
    lift = lambda p: np.hstack([p, np.zeros((p.shape[0], 1))])
    i2Si1, _ = align_points_sim3(lift(pts2), lift(pts1))
    theta_deg = rotmat2theta_deg(i2Si1.rotation)
    return Sim2(R=rotmat2d(theta_deg), t=i2Si1.translation, s=1.0)


def align_pair_measurement_by_vanishing_angle(
    i1: int,
    i2: int,
    i2Si1: Sim2,
    edge_wdo_pair: EdgeWDOPair,
    pano_dict_inferred: Dict[int, PanoData],
    visualize: bool = False,
) -> Optional[Sim2]:
    """Refine one relative pose by vanishing angles (parity :175).

    Rotates pano 1's layout about the W/D/O midpoint by the vanishing-angle
    correction, then re-fits the relative pose. Returns None if the
    correction exceeds MAX_ALLOWED_CORRECTION_DEG.
    """
    alignment_object = edge_wdo_pair.alignment_object
    i1_wdo_idx = edge_wdo_pair.i1_wdo_idx
    wdos = getattr(pano_dict_inferred[i1], alignment_object + "s")
    i1wdocenter_i1fr = wdos[i1_wdo_idx].centroid
    i1wdocenter_i2fr = i2Si1.transform_from(i1wdocenter_i1fr.reshape(1, 2)).squeeze()

    vertsi1 = pano_dict_inferred[i1].room_vertices_local_2d
    vertsi1_i2fr = i2Si1.transform_from(vertsi1)

    vp_i1 = pano_dict_inferred[i1].vanishing_angle_deg
    vp_i2 = pano_dict_inferred[i2].vanishing_angle_deg
    if vp_i1 is None or vp_i2 is None:
        return None
    i2r_theta_i2 = compute_vp_correction(i2Si1, vp_i1, vp_i2)

    if np.absolute(i2r_theta_i2) > MAX_ALLOWED_CORRECTION_DEG:
        return None

    i2r_R_i2 = rotmat2d(i2r_theta_i2)
    vertsi1_i2fr_r = rotate_polygon_about_pt(
        vertsi1_i2fr, rotmat=i2r_R_i2, center_pt=i1wdocenter_i2fr
    )
    return compute_i2Ti1(pts1=vertsi1, pts2=vertsi1_i2fr_r)


def align_pairs_by_vanishing_angle(
    i2Si1_dict: Dict[Tuple[int, int], Sim2],
    inferred_floor_pose_graph,
    per_edge_wdo_dict: Dict[Tuple[int, int], EdgeWDOPair],
    visualize: bool = False,
) -> Dict[Tuple[int, int], Sim2]:
    """Refine every edge's relative pose by vanishing angle (parity :129)."""
    pano_dict_inferred = inferred_floor_pose_graph.nodes
    for (i1, i2), i2Si1 in list(i2Si1_dict.items()):
        edge_wdo_pair = per_edge_wdo_dict[(i1, i2)]
        i2rSi1 = align_pair_measurement_by_vanishing_angle(
            i1, i2, i2Si1, edge_wdo_pair, pano_dict_inferred, visualize
        )
        if i2rSi1 is not None:
            i2Si1_dict[(i1, i2)] = i2rSi1
    return i2Si1_dict
