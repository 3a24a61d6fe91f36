"""Data association for landmark-based SLAM: W/D/O endpoints as keypoints.

Parity: salve/algorithms/data_association.py. The reference wrapped GTSFM's
Keypoints/SfmTrack2d built on GTSAM's C++ disjoint-set forest; here a plain
Python union-find generates the same landmark tracks (graphs are tiny —
this is host-side bookkeeping, not device math).

Keypoint ordering per pano (data_association.py:21-48): grouped by twos as
(start, end) per W/D/O; openings first, then windows, then doors.

A copy of salve_tpu/algorithms/data_association.py (no JAX).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

from salve_tpu_torch.common.pano_data import PanoData

# A track is a list of (pano_id, kpt_idx) measurements of one landmark.
Track = List[Tuple[int, int]]


def get_kpt_idx(wdo_idx: int, wdo_object_type: str, pano_data: PanoData) -> int:
    """Keypoint index of a W/D/O's START vertex within its pano's list."""
    num_openings = len(pano_data.openings)
    num_windows = len(pano_data.windows)
    if wdo_object_type == "opening":
        return wdo_idx * 2
    if wdo_object_type == "window":
        return (num_openings + wdo_idx) * 2
    if wdo_object_type == "door":
        return (num_openings + num_windows + wdo_idx) * 2
    raise ValueError(f"Unknown W/D/O type {wdo_object_type}")


def get_kpt_coordinate(pano_data: PanoData, kpt_idx: int) -> np.ndarray:
    """2D coordinate (pano-local frame) of keypoint `kpt_idx`."""
    coords: List[np.ndarray] = []
    for obj_type in ["openings", "windows", "doors"]:
        for wdo in getattr(pano_data, obj_type) or []:
            coords.append(np.asarray(wdo.pt1, dtype=np.float64))
            coords.append(np.asarray(wdo.pt2, dtype=np.float64))
    return coords[kpt_idx]


class _UnionFind:
    """Path-compressed union-find over hashable keys."""

    def __init__(self) -> None:
        self.parent: Dict = {}

    def find(self, x):
        self.parent.setdefault(x, x)
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, a, b) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def generate_tracks_from_pairwise_matches(
    matches_dict: Dict[Tuple[int, int], np.ndarray]
) -> List[Track]:
    """Union-find track generation (GTSFM SfmTrack2d semantics).

    Tracks where the same pano contributes more than one keypoint are
    dropped as erroneous (a landmark is seen at most once per pano).
    """
    uf = _UnionFind()
    for (i1, i2), matches in matches_dict.items():
        for k1, k2 in np.asarray(matches).reshape(-1, 2):
            uf.union((i1, int(k1)), (i2, int(k2)))

    groups: Dict = defaultdict(list)
    for key in list(uf.parent.keys()):
        groups[uf.find(key)].append(key)

    tracks: List[Track] = []
    for members in groups.values():
        if len(members) < 2:
            continue
        pano_ids = [m[0] for m in members]
        if len(set(pano_ids)) != len(pano_ids):
            continue  # erroneous track: repeated pano
        tracks.append(sorted(members))
    return tracks


def perform_data_association(
    measurements,
    per_edge_wdo_dict=None,
    inferred_floor_pose_graph=None,
    pano_dict_inferred: Dict[int, PanoData] = None,
) -> List[Track]:
    """Create landmark tracks from verified W/D/O-pair measurements.

    Args:
        measurements: EdgeClassification-like objects (with .wdo_pair_uuid
            like "door_3_0" and .configuration in {identity, rotated}).
        pano_dict_inferred: pano ID -> PanoData (W/D/O lists used only).

    Returns:
        Landmark tracks as lists of (pano_id, kpt_idx).
    """
    if pano_dict_inferred is None and inferred_floor_pose_graph is not None:
        pano_dict_inferred = inferred_floor_pose_graph.nodes

    matches_dict: Dict[Tuple[int, int], List[Tuple[int, int]]] = defaultdict(list)
    for m in measurements:
        i1, i2 = m.i1, m.i2
        alignment_object, i, j = m.wdo_pair_uuid.split("_")
        i, j = int(i), int(j)

        s_1 = get_kpt_idx(i, alignment_object, pano_dict_inferred[i1])
        s_2 = get_kpt_idx(j, alignment_object, pano_dict_inferred[i2])
        e_1, e_2 = s_1 + 1, s_2 + 1

        if m.configuration == "rotated":
            # 1's start vertex corresponds to 2's END vertex.
            matches_dict[(i1, i2)] += [(s_1, e_2), (e_1, s_2)]
        else:
            matches_dict[(i1, i2)] += [(s_1, s_2), (e_1, e_2)]

    matches_arr = {k: np.array(v) for k, v in matches_dict.items()}
    return generate_tracks_from_pairwise_matches(matches_arr)
