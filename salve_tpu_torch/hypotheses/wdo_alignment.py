"""Exhaustive pairwise W/D/O alignment (Stage A core).

Parity: salve/utils/wdo_alignment.py. Every same-type W/D/O pair between two
panos (doors x doors, windows x windows, openings x openings), in identity and
(for doors/openings) rotated configuration, yields a candidate SE(2)/Sim(3)
relative pose fit on the 5-vertex W/D/O outline. Candidates are pruned by
W/D/O width ratio and (GT mode only) freespace-penetration checks.

This module is the host-level single-pair API; the floor-level batched
product over (pair x wdo x wdo x configuration) on the card lives in
salve_tpu_torch/hypotheses/batched.py.

A copy of salve_tpu/hypotheses/wdo_alignment.py, using the port's
point_alignment: its Sim(3) fit runs in float32 on the CPU, as JAX's does.
"""

from __future__ import annotations

from enum import Enum
from typing import List, Tuple

import numpy as np

import salve_tpu_torch.geometry.point_alignment as point_alignment
import salve_tpu_torch.geometry.polygons as polygons
from salve_tpu_torch.common.alignment_hypothesis import AlignmentHypothesis
from salve_tpu_torch.common.pano_data import PanoData
from salve_tpu_torch.common.wdo import WDO
from salve_tpu_torch.geometry.rotations import angle_is_equal
from salve_tpu_torch.geometry.sim2 import Sim2

# Width ratio (smaller/larger) thresholds for plausible W/D/O matches.
MIN_ALLOWED_INFERRED_WDO_WIDTH_RATIO = 0.65
MIN_ALLOWED_GT_WDO_WIDTH_RATIO = 0.8

# Tolerances for GT-approx labeling of hypotheses (degrees / normalized units).
OPENING_ALIGNMENT_ANGLE_TOLERANCE = 9.0
DOOR_WINDOW_ALIGNMENT_ANGLE_TOLERANCE = 7.0
ALIGNMENT_TRANSLATION_TOLERANCE = 0.35

DEFAULT_OVERLAP_CHECK_SHRINK_FACTOR = 0.1


class AlignTransformType(str, Enum):
    """Which transform family to fit between two panoramas."""

    SE2 = "SE2"
    Sim3 = "Sim3"


def get_all_pano_wd_vertices(pano_obj: PanoData) -> np.ndarray:
    """(N,3) stack of all W/D/O outline vertices in the pano's local frame."""
    polys = [
        wd.polygon_vertices_local_3d
        for wd in pano_obj.windows + pano_obj.doors + pano_obj.openings
    ]
    return np.vstack(polys) if polys else np.zeros((0, 3))


def determine_invalid_width_ratio(
    pano1_wd: WDO, pano2_wd: WDO, use_inferred_wdos_layout: bool
) -> Tuple[bool, float]:
    """Whether two W/D/Os have plausibly matching widths.

    Returns (is_valid, width_ratio) with width_ratio = min(w1,w2)/max(w1,w2).
    """
    w1, w2 = pano1_wd.width, pano2_wd.width
    width_ratio = min(w1, w2) / max(w1, w2)
    min_allowed = (
        MIN_ALLOWED_INFERRED_WDO_WIDTH_RATIO
        if use_inferred_wdos_layout
        else MIN_ALLOWED_GT_WDO_WIDTH_RATIO
    )
    return width_ratio >= min_allowed, width_ratio


def obj_almost_equal(i2Ti1: Sim2, i2Ti1_: Sim2, wdo_alignment_object: str) -> bool:
    """Tolerance-equality of two relative poses, with looser angle for openings."""
    if not np.allclose(i2Ti1.translation, i2Ti1_.translation, atol=ALIGNMENT_TRANSLATION_TOLERANCE):
        return False
    if not np.isclose(i2Ti1.scale, i2Ti1_.scale, atol=0.35):
        return False
    if wdo_alignment_object in ("door", "window"):
        angle_tol = DOOR_WINDOW_ALIGNMENT_ANGLE_TOLERANCE
    elif wdo_alignment_object == "opening":
        angle_tol = OPENING_ALIGNMENT_ANGLE_TOLERANCE
    else:
        raise RuntimeError(f"Unknown W/D/O type {wdo_alignment_object}")
    return angle_is_equal(i2Ti1.theta_deg, i2Ti1_.theta_deg, atol=angle_tol)


def _plausible_configurations(alignment_object: str) -> List[str]:
    # A window looks the same from both sides of a wall; doors/openings are
    # pass-throughs that may be seen from either side.
    return ["identity"] if alignment_object == "window" else ["identity", "rotated"]


def align_rooms_by_wd(
    pano1_obj: PanoData,
    pano2_obj: PanoData,
    transform_type: AlignTransformType,
    use_inferred_wdos_layout: bool,
    verbose: bool = False,
) -> Tuple[List[AlignmentHypothesis], int]:
    """Generate relative-pose hypotheses i2Ti1 from all same-type W/D/O pairings.

    Args:
        pano1_obj / pano2_obj: panorama data (GT-annotated or MHNet-inferred).
        transform_type: SE(2) (gravity-aligned 2-point fit) or Sim(3).
        use_inferred_wdos_layout: inferred mode prunes by width ratio only;
            GT mode additionally runs the freespace-penetration check.

    Returns:
        (hypotheses, num_invalid_configurations).
    """
    num_invalid = 0
    hypotheses: List[AlignmentHypothesis] = []

    for alignment_object, pano1_wds, pano2_wds in (
        ("door", pano1_obj.doors, pano2_obj.doors),
        ("window", pano1_obj.windows, pano2_obj.windows),
        ("opening", pano1_obj.openings, pano2_obj.openings),
    ):
        for i, pano1_wd in enumerate(pano1_wds):
            pano1_wd_pts = pano1_wd.polygon_vertices_local_3d
            for j, pano2_wd in enumerate(pano2_wds):
                for configuration in _plausible_configurations(alignment_object):
                    pano2_wd_ = (
                        pano2_wd.get_rotated_version()
                        if configuration == "rotated"
                        else pano2_wd
                    )
                    pano2_wd_pts = pano2_wd_.polygon_vertices_local_3d

                    if transform_type == AlignTransformType.SE2:
                        i2Ti1, _ = point_alignment.align_points_SE2(
                            pano2_wd_pts[:, :2], pano1_wd_pts[:, :2]
                        )
                    elif transform_type == AlignTransformType.Sim3:
                        i2Ti1, _ = point_alignment.align_points_sim3(pano2_wd_pts, pano1_wd_pts)
                    else:
                        raise RuntimeError(f"Unknown transform type {transform_type}")

                    if use_inferred_wdos_layout:
                        is_valid, width_ratio = determine_invalid_width_ratio(
                            pano1_wd, pano2_wd_, use_inferred_wdos_layout
                        )
                    else:
                        width_is_valid, width_ratio = determine_invalid_width_ratio(
                            pano1_wd, pano2_wd_, use_inferred_wdos_layout
                        )
                        pano1_room_in_i2 = i2Ti1.transform_from(
                            pano1_obj.room_vertices_local_2d
                        )
                        freespace_is_valid = polygons.determine_invalid_wall_overlap(
                            pano1_room_vertices=pano1_room_in_i2,
                            pano2_room_vertices=pano2_obj.room_vertices_local_2d,
                            shrink_factor=DEFAULT_OVERLAP_CHECK_SHRINK_FACTOR,
                        )
                        is_valid = freespace_is_valid and width_is_valid

                    if verbose:
                        print(
                            f"Valid? {is_valid} -> Width: {alignment_object} {i} {j} "
                            f"{configuration} -> {width_ratio:.2f}"
                        )

                    if is_valid:
                        hypotheses.append(
                            AlignmentHypothesis(
                                i2Ti1=i2Ti1,
                                wdo_alignment_object=alignment_object,
                                i1_wdo_idx=i,
                                i2_wdo_idx=j,
                                configuration=configuration,
                            )
                        )
                    else:
                        num_invalid += 1

    return hypotheses, num_invalid


def _point_to_segment_dist(p: np.ndarray, a: np.ndarray, b: np.ndarray) -> float:
    ab = b - a
    denom = float(ab @ ab)
    t = 0.0 if denom == 0 else float(np.clip((p - a) @ ab / denom, 0.0, 1.0))
    return float(np.linalg.norm(p - (a + t * ab)))


def segment_hausdorff_distance(seg1: np.ndarray, seg2: np.ndarray) -> float:
    """Hausdorff distance between two 2-point segments (endpoint-to-segment form)."""
    d12 = max(_point_to_segment_dist(p, seg2[0], seg2[1]) for p in seg1)
    d21 = max(_point_to_segment_dist(p, seg1[0], seg1[1]) for p in seg2)
    return max(d12, d21)


def are_visibly_adjacent(pano1_obj: PanoData, pano2_obj: PanoData) -> bool:
    """True if any two W/D/Os from the panos nearly coincide in the world frame.

    Parity: scripts/export_alignment_hypotheses.py:43 (Shapely Hausdorff on
    2-point LineStrings, threshold 0.1 in world-normalized units).
    """
    DIST_THRESH = 0.1
    wdos1 = pano1_obj.windows + pano1_obj.doors + pano1_obj.openings
    wdos2 = pano2_obj.windows + pano2_obj.doors + pano2_obj.openings
    for wdo1 in wdos1:
        v1 = wdo1.vertices_global_2d
        for wdo2 in wdos2:
            if segment_hausdorff_distance(v1, wdo2.vertices_global_2d) < DIST_THRESH:
                return True
    return False
