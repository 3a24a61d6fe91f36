"""Greedy + RANSAC spanning-tree global pose initialization.

Parity: salve/algorithms/spanning_tree.py. Graph traversal (largest CC,
shortest paths) stays host-side — it is graph-shaped and tiny — while pose
chaining and per-hypothesis error scoring are vectorized array ops.

A copy of salve_tpu/algorithms/spanning_tree.py (no JAX) on the port's
graph helper (utils/graph.py) instead of networkx.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from salve_tpu_torch.geometry.rotations import wrap_angle_deg
from salve_tpu_torch.geometry.sim2 import Sim2
from salve_tpu_torch.utils import graph
from salve_tpu_torch.utils.graph_utils import get_nodes_in_largest_connected_component


def greedily_construct_st(
    i2Ri1_dict: Dict[Tuple[int, int], np.ndarray]
) -> List[Optional[np.ndarray]]:
    """Chain relative rotations along shortest paths from an origin node."""
    edges = list(i2Ri1_dict.keys())
    num_nodes = max(max(i1, i2) for i1, i2 in edges) + 1
    cc_nodes = sorted(get_nodes_in_largest_connected_component(edges))

    wRi_list: List[Optional[np.ndarray]] = [None] * num_nodes
    origin_node = cc_nodes[0]
    wRi_list[origin_node] = np.eye(2)

    G = graph.Graph()
    G.add_edges_from(edges)
    paths = graph.single_source_shortest_path(G, origin_node)
    for dst_node in cc_nodes[1:]:
        path = paths[dst_node]
        wRi = np.eye(2)
        for i1, i2 in zip(path[:-1], path[1:]):
            i1Ri2 = i2Ri1_dict[(i1, i2)].T if i1 < i2 else i2Ri1_dict[(i2, i1)]
            wRi = wRi @ i1Ri2
        wRi_list[dst_node] = wRi
    return wRi_list


def greedily_construct_st_Sim2(
    i2Si1_dict: Dict[Tuple[int, int], Sim2], verbose: bool = False
) -> Optional[List[Optional[Sim2]]]:
    """Chain Sim(2) relative poses along shortest paths from the smallest
    pano ID in the largest CC (parity: spanning_tree.py:73).

    Shortest-path chaining minimizes accumulated drift.
    """
    edges = list(i2Si1_dict.keys())
    if not edges:
        return None

    num_nodes = max(max(i1, i2) for i1, i2 in edges) + 1
    cc_nodes = sorted(get_nodes_in_largest_connected_component(edges))

    wSi_list: List[Optional[Sim2]] = [None] * num_nodes
    origin_node = cc_nodes[0]
    wSi_list[origin_node] = Sim2.identity()

    G = graph.Graph()
    G.add_edges_from(edges)
    paths = graph.single_source_shortest_path(G, origin_node)

    for dst_node in cc_nodes[1:]:
        path = paths[dst_node]
        wSi = Sim2.identity()
        for i1, i2 in zip(path[:-1], path[1:]):
            i1Si2 = i2Si1_dict[(i1, i2)].inverse() if i1 < i2 else i2Si1_dict[(i2, i1)]
            wSi = wSi.compose(i1Si2)
        wSi_list[dst_node] = wSi
    return wSi_list


def compute_hypothesis_errors(
    measurements, wSi_list: List[Optional[Sim2]]
) -> Tuple[float, float, float, float]:
    """Deviation of synthesized relative poses (from globals) vs measurements.

    Returns (avg_rot_err_deg, med_rot_err_deg, avg_trans_err, med_trans_err).
    """
    rot_errors, trans_errors = [], []
    for m in measurements:
        if m.i1 >= len(wSi_list) or m.i2 >= len(wSi_list):
            continue
        wSi1, wSi2 = wSi_list[m.i1], wSi_list[m.i2]
        if wSi1 is None or wSi2 is None:
            continue
        i2Si1_sim = wSi2.inverse().compose(wSi1)
        rot_errors.append(wrap_angle_deg(i2Si1_sim.theta_deg, m.i2Si1.theta_deg))
        trans_errors.append(
            float(np.linalg.norm(i2Si1_sim.translation - m.i2Si1.translation))
        )
    if not rot_errors:
        return np.inf, np.inf, np.inf, np.inf
    return (
        float(np.mean(rot_errors)),
        float(np.median(rot_errors)),
        float(np.mean(trans_errors)),
        float(np.median(trans_errors)),
    )


def compute_objective_function_improvement(
    avg_rot_error: float,
    avg_rot_error_best: float,
    avg_trans_error: float,
    avg_trans_error_best: float,
    num_poses_estimated: int,
    num_poses_estimated_best: int,
) -> float:
    """Pareto trade-off: completeness vs per-edge accuracy (parity :144)."""
    EPS = 1e-10
    rot_improvement = (avg_rot_error_best - avg_rot_error) / 5
    trans_improvement = avg_trans_error_best - avg_trans_error
    loc_completeness_improvement = -(num_poses_estimated_best - num_poses_estimated) / (
        num_poses_estimated_best + EPS
    )
    return rot_improvement + trans_improvement + 1.33 * loc_completeness_improvement


def ransac_spanning_trees(
    measurements,
    num_hypotheses: int = 10,
    gt_floor_pose_graph=None,
    visualize: bool = False,
    sampling_fraction: float = 0.5,
    min_num_edges_for_hypothesis: Optional[int] = None,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[Optional[List[Optional[Sim2]]], Optional[List]]:
    """Sample random spanning trees, keep the Pareto-best (parity :179).

    Sampling is biased toward pairs captured close in sequence
    (probability ~ 1/|i2-i1|).

    Returns (best global poses, the winning measurement subset).
    """
    if len(measurements) == 0:
        raise ValueError("At least one edge prediction/measurement must be provided.")
    rng = rng or np.random.default_rng()

    K = len(measurements)
    if min_num_edges_for_hypothesis is None:
        min_num_edges_for_hypothesis = int(math.ceil(sampling_fraction * K))
    min_num_edges_for_hypothesis = min(min_num_edges_for_hypothesis, K)

    try:
        from scipy.special import comb

        max_unique = int(comb(K, min_num_edges_for_hypothesis))
    except (OverflowError, ValueError):
        max_unique = 1000
    num_hypotheses = min(max(max_unique, 1), num_hypotheses)

    capture_distance = np.array(
        [max(abs(m.i2 - m.i1), 1) for m in measurements], dtype=np.float64
    )
    probabilities = 1.0 / capture_distance
    probabilities /= probabilities.sum()

    best = {
        "avg_rot": np.inf,
        "avg_trans": np.inf,
        "num_poses": 0,
        "wSi_list": None,
        "hypothesis": None,
    }

    for _ in range(num_hypotheses):
        h_idxs = set(
            rng.choice(K, size=min_num_edges_for_hypothesis, replace=False, p=probabilities)
        )
        hyp_ms = [m for k, m in enumerate(measurements) if k in h_idxs]

        i2Si1_dict = {(m.i1, m.i2): m.i2Si1 for m in hyp_ms}
        wSi_list = greedily_construct_st_Sim2(i2Si1_dict, verbose=False)
        if wSi_list is None:
            continue

        avg_rot, _, avg_trans, _ = compute_hypothesis_errors(measurements, wSi_list)
        num_poses = sum(1 for w in wSi_list if w is not None)

        if (
            compute_objective_function_improvement(
                avg_rot, best["avg_rot"], avg_trans, best["avg_trans"], num_poses, best["num_poses"]
            )
            > 0
        ):
            best.update(
                avg_rot=avg_rot,
                avg_trans=avg_trans,
                num_poses=num_poses,
                wSi_list=wSi_list,
                hypothesis=hyp_ms,
            )

    return best["wSi_list"], best["hypothesis"]
