"""Cycle-triplet extraction and cycle-error filtering.

Parity: salve/algorithms/cycle_consistency.py. Triplet discovery stays
host-side (adjacency-list set intersections — graph-shaped, tiny); cycle
errors are computed for ALL triplets at once as stacked array ops instead
of the reference's per-triplet Python loop of Sim2 object compositions.

A copy of salve_tpu/algorithms/cycle_consistency.py (no JAX).
"""

from __future__ import annotations

from collections import defaultdict
from typing import DefaultDict, Dict, List, Optional, Set, Tuple

import numpy as np

from salve_tpu_torch.common.two_view_estimation_report import TwoViewEstimationReport
from salve_tpu_torch.geometry.rotations import rotmat2theta_deg
from salve_tpu_torch.geometry.sim2 import Sim2

ROT_CYCLE_ERROR_THRESHOLD = 0.5  # degrees (cycle_consistency.py:23)
SE2_CYCLE_ROT_THRESHOLD_DEG = 0.5
SE2_CYCLE_TRANS_THRESHOLD = 0.01


def create_adjacency_list(
    edges: Dict[Tuple[int, int], object]
) -> DefaultDict[int, Set[int]]:
    """Adjacency list of the measurement graph (None edges skipped)."""
    adj_list: DefaultDict[int, Set[int]] = defaultdict(set)
    for (i1, i2), val in edges.items():
        if val is None:
            continue
        adj_list[i1].add(i2)
        adj_list[i2].add(i1)
    return adj_list


def extract_triplets(edges: Dict[Tuple[int, int], object]) -> List[Tuple[int, int, int]]:
    """All 3-cycles, via adjacency-list intersection (not O(n^3))."""
    adj_list = create_adjacency_list(edges)
    triplets = set()
    for (i1, i2), val in edges.items():
        if val is None:
            continue
        if i1 >= i2:
            raise RuntimeError("Graph edges (i1,i2) must be ordered with i1 < i2.")
        for node in adj_list[i1].intersection(adj_list[i2]):
            triplets.add(tuple(sorted([i1, i2, node])))
    return list(triplets)


def _stack_sim2(
    i2Si1_dict: Dict[Tuple[int, int], Sim2], triplets: List[Tuple[int, int, int]]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-triplet composed-cycle Sim(2): i0Si2^-1 * i2Si1 * i1Si0, batched.

    Returns (theta_err_deg (T,), trans_err (T,)).
    """
    T = len(triplets)
    R = np.zeros((T, 3, 2, 2))
    t = np.zeros((T, 3, 2))
    s = np.zeros((T, 3))
    for k, (i0, i1, i2) in enumerate(triplets):
        for j, e in enumerate([(i0, i1), (i1, i2), (i0, i2)]):
            S = i2Si1_dict[e]
            R[k, j] = S.rotation
            t[k, j] = S.translation
            s[k, j] = S.scale
    return R, t, s


def _batched_cycle_errors(
    R: np.ndarray, t: np.ndarray, s: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized Sim(2) cycle composition for T triplets.

    Edge order per row: a=i1Si0, b=i2Si1, c=i2Si0 (the (i0,i2) edge);
    cycle = c^-1 * b * a. Composition rule matches Sim2.compose:
    (Ra, ta, sa)*(Rb, tb, sb) = (Ra Rb, Ra tb + ta/sb, sa sb).
    """
    Ra, ta, sa = R[:, 0], t[:, 0], s[:, 0]
    Rb, tb, sb = R[:, 1], t[:, 1], s[:, 1]
    Rc, tc, sc = R[:, 2], t[:, 2], s[:, 2]

    # c^-1
    Rci = np.swapaxes(Rc, 1, 2)
    tci = -np.einsum("nij,nj->ni", Rci, tc * sc[:, None])
    sci = 1.0 / sc

    # d = c^-1 * b
    Rd = Rci @ Rb
    td = np.einsum("nij,nj->ni", Rci, tb) + tci / sb[:, None]
    sd = sci * sb

    # e = d * a
    Re = Rd @ Ra
    te = np.einsum("nij,nj->ni", Rd, ta) + td / sa[:, None]

    theta_err = np.abs(np.degrees(np.arctan2(Re[:, 1, 0], Re[:, 0, 0])))
    trans_err = np.linalg.norm(te, axis=1)
    return theta_err, trans_err


def compute_SE2_cycle_error(
    i2Si1_dict: Dict[Tuple[int, int], Sim2],
    cycle_nodes: Tuple[int, int, int],
    two_view_reports_dict=None,
    verbose: bool = False,
) -> Tuple[float, float]:
    """(rot_error_deg, trans_error) of one composed Sim(2) triplet cycle."""
    R, t, s = _stack_sim2(i2Si1_dict, [tuple(sorted(cycle_nodes))])
    theta_err, trans_err = _batched_cycle_errors(R, t, s)
    return float(theta_err[0]), float(trans_err[0])


def compute_rot_cycle_error(
    i2Ri1_dict: Dict[Tuple[int, int], np.ndarray],
    cycle_nodes: Tuple[int, int, int],
    two_view_reports_dict: Optional[Dict] = None,
    verbose: bool = False,
) -> Tuple[float, Optional[float], Optional[float]]:
    """Rotation-only cycle error + max GT (R,t) error across triplet edges."""
    i0, i1, i2 = sorted(cycle_nodes)
    i1Ri0 = i2Ri1_dict[(i0, i1)]
    i2Ri1 = i2Ri1_dict[(i1, i2)]
    i0Ri2 = i2Ri1_dict[(i0, i2)].T
    i0Ri0 = i0Ri2 @ i2Ri1 @ i1Ri0
    cycle_error = abs(rotmat2theta_deg(i0Ri0))

    max_rot_error = max_trans_error = None
    if two_view_reports_dict is not None:
        edges = [(i0, i1), (i1, i2), (i0, i2)]
        rot_errors = [two_view_reports_dict[e].R_error_deg for e in edges]
        trans_errors = [two_view_reports_dict[e].U_error_deg for e in edges]
        if all(e is not None for e in rot_errors):
            max_rot_error = float(np.max(rot_errors))
            max_trans_error = float(np.max(trans_errors))
    return cycle_error, max_rot_error, max_trans_error


def filter_to_SE2_cycle_consistent_edges(
    i2Si1_dict: Dict[Tuple[int, int], Sim2],
    two_view_reports_dict=None,
    SE2_cycle_rot_threshold_deg: float = SE2_CYCLE_ROT_THRESHOLD_DEG,
    SE2_cycle_trans_threshold: float = SE2_CYCLE_TRANS_THRESHOLD,
    visualize: bool = False,
    verbose: bool = False,
) -> Dict[Tuple[int, int], Sim2]:
    """Keep edges that participate in >=1 triplet passing BOTH thresholds.

    Parity: cycle_consistency.py:225 — but all triplets are scored in one
    batched composition rather than one Python loop iteration each.
    """
    triplets = extract_triplets(i2Si1_dict)
    if not triplets:
        return {}

    R, t, s = _stack_sim2(i2Si1_dict, triplets)
    theta_err, trans_err = _batched_cycle_errors(R, t, s)
    ok = (theta_err < SE2_cycle_rot_threshold_deg) & (
        trans_err < SE2_cycle_trans_threshold
    )

    cycle_consistent_keys: Set[Tuple[int, int]] = set()
    for k, (i0, i1, i2) in enumerate(triplets):
        if ok[k]:
            cycle_consistent_keys.update([(i0, i1), (i1, i2), (i0, i2)])

    return {e: i2Si1_dict[e] for e in cycle_consistent_keys}


def filter_to_rotation_cycle_consistent_edges(
    i2Ri1_dict: Dict[Tuple[int, int], np.ndarray],
    i2Ui1_dict: Optional[Dict[Tuple[int, int], np.ndarray]] = None,
    two_view_reports_dict: Optional[Dict] = None,
    visualize: bool = False,
    cycle_error_threshold: float = ROT_CYCLE_ERROR_THRESHOLD,
) -> Tuple[Dict[Tuple[int, int], np.ndarray], Dict[Tuple[int, int], np.ndarray]]:
    """Keep edges in >=1 rotation-consistent triplet (cycle_consistency.py:306)."""
    triplets = extract_triplets(i2Ri1_dict)
    consistent: Set[Tuple[int, int]] = set()
    for trip in triplets:
        err, _, _ = compute_rot_cycle_error(i2Ri1_dict, trip)
        if err < cycle_error_threshold:
            i0, i1, i2 = trip
            consistent.update([(i0, i1), (i1, i2), (i0, i2)])

    i2Ri1_consistent = {e: i2Ri1_dict[e] for e in consistent}
    i2Ui1_consistent = (
        {e: i2Ui1_dict[e] for e in consistent if e in i2Ui1_dict}
        if i2Ui1_dict is not None
        else {}
    )
    return i2Ri1_consistent, i2Ui1_consistent


def estimate_rot_cycle_filtering_classification_acc(
    i2Ri1_dict: Dict[Tuple[int, int], np.ndarray],
    i2Ri1_dict_consistent: Dict[Tuple[int, int], np.ndarray],
    two_view_reports_dict: Dict[Tuple[int, int], TwoViewEstimationReport],
) -> float:
    """Precision of cycle filtering treated as a binary classifier
    (kept edge = predicted inlier); parity: cycle_consistency.py:596."""
    if not i2Ri1_dict_consistent:
        return 0.0
    kept_gt = [
        two_view_reports_dict[e].gt_class for e in i2Ri1_dict_consistent.keys()
    ]
    return float(np.mean(np.array(kept_gt) == 1))
