"""Group panoramas into rooms by layout-polygon overlap.

Parity: salve/algorithms/room_merging.py — two panos share a room when
their global layout polygons have IoU > 0.1 OR either polygon's overlap
ratio exceeds 0.3. The reference used Shapely/GEOS exact intersections;
here overlap areas come from the GEOS-free raster predicate in
salve_tpu.geometry.polygons.

A copy of salve_tpu/algorithms/room_merging.py (no JAX) on the port's graph
helper (utils/graph.py) instead of networkx. The grid is built on the host
with the reference's expressions; its containment test runs in torch
(ops/raster.py:points_in_polygon_grid) on `device`, None being the CUDA
card. The masks are booleans, so the counts and ratios equal the numpy
reference's.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from salve_tpu_torch.device import DeviceLike, resolve_device
from salve_tpu_torch.ops.raster import points_in_polygon_grid
from salve_tpu_torch.utils.graph import Graph, connected_components

MIN_LAYOUT_OVERLAP_RATIO = 0.3
MIN_LAYOUT_OVERLAP_IOU = 0.1


def _pairwise_overlap(poly_a: np.ndarray, poly_b: np.ndarray, resolution: float = 0.05,
                      device: torch.device = torch.device("cpu")):
    """(iou, overlap_ratio_a, overlap_ratio_b) via a shared raster grid."""
    mins = np.minimum(poly_a.min(axis=0), poly_b.min(axis=0)) - resolution
    maxs = np.maximum(poly_a.max(axis=0), poly_b.max(axis=0)) + resolution
    nx_ = min(max(int(np.ceil((maxs[0] - mins[0]) / resolution)), 1), 1500)
    ny_ = min(max(int(np.ceil((maxs[1] - mins[1]) / resolution)), 1), 1500)
    xs = mins[0] + (np.arange(nx_) + 0.5) * (maxs[0] - mins[0]) / nx_
    ys = mins[1] + (np.arange(ny_) + 0.5) * (maxs[1] - mins[1]) / ny_
    xs_t = torch.as_tensor(xs, device=device)
    ys_t = torch.as_tensor(ys, device=device)
    in_a = points_in_polygon_grid(torch.as_tensor(poly_a, dtype=torch.float64, device=device), xs_t, ys_t)
    in_b = points_in_polygon_grid(torch.as_tensor(poly_b, dtype=torch.float64, device=device), xs_t, ys_t)
    counts = torch.stack([(in_a & in_b).sum(), (in_a | in_b).sum(), in_a.sum(), in_b.sum()]).tolist()
    inter, union, area_a, area_b = (float(c) for c in counts)
    eps = 1e-10
    return inter / (union + eps), inter / (area_a + eps), inter / (area_b + eps)


def group_panos_by_room(est_pose_graph, visualize: bool = False, device: DeviceLike = None) -> List[List[int]]:
    """Connected components of the layout-overlap graph (parity :22)."""
    dev = resolve_device(device)
    pano_ids = est_pose_graph.pano_ids()
    polys = {
        pid: np.asarray(est_pose_graph.nodes[pid].room_vertices_global_2d)
        for pid in pano_ids
    }

    graph = Graph()
    graph.add_nodes_from(pano_ids)
    for i in range(len(pano_ids)):
        for j in range(i, len(pano_ids)):
            p1, p2 = pano_ids[i], pano_ids[j]
            # Cheap bbox rejection before rasterizing.
            if i != j:
                a, b = polys[p1], polys[p2]
                if (a.max(0) < b.min(0)).any() or (b.max(0) < a.min(0)).any():
                    continue
            iou, r1, r2 = _pairwise_overlap(polys[p1], polys[p2], device=dev)
            if (
                iou > MIN_LAYOUT_OVERLAP_IOU
                or r1 > MIN_LAYOUT_OVERLAP_RATIO
                or r2 > MIN_LAYOUT_OVERLAP_RATIO
            ):
                graph.add_edges_from([(p1, p2)])
    return [[*c] for c in sorted(connected_components(graph))]
