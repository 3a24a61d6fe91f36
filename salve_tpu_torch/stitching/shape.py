"""Dense shape generation + confidence-weighted multi-pano fusion.

Parity: salve/stitching/shape.py — shapes are (N,2) numpy rings instead of
Shapely polygons; room grouping reuses the GEOS-free raster overlap from
salve_tpu.algorithms.room_merging.

A copy of salve_tpu/stitching/shape.py (no JAX) on the port's graph helper
(utils/graph.py) instead of networkx. The raster containment of room
grouping and of the stitch IoU (`_union_mask_on_grid`) runs in torch
(ops/raster.py:points_in_polygon_grid) on `device`, None being the CUDA
card; grids are built on the host with the reference's expressions. The
fusion itself (`refine_shape_group_start_with`) stays numpy on the host,
with its single-point containment test.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from salve_tpu_torch.device import DeviceLike, resolve_device
from salve_tpu_torch.geometry.polygons import points_in_polygon
from salve_tpu_torch.ops.raster import points_in_polygon_grid
from salve_tpu_torch.stitching import transform as transform_utils
from salve_tpu_torch.stitching.constants import (
    DEFAULT_CAMERA_HEIGHT,
    IMAGE_HEIGHT_PX,
    IMAGE_WIDTH_PX,
)
from salve_tpu_torch.stitching.models import Point2d, Pose
from salve_tpu_torch.utils.graph import Graph, connected_components

MIN_LAYOUT_OVERLAP_RATIO = 0.3
MIN_LAYOUT_OVERLAP_IOU = 0.1


def generate_polygon_from_room_shape_vertices(vertices: List[dict]) -> np.ndarray:
    """[{'x':..,'y':..}, ...] -> (N,2) ring."""
    return np.array([[v["x"], v["y"]] for v in vertices], dtype=np.float64)


def extract_coordinates_from_polygon(shape: np.ndarray) -> List[Point2d]:
    """(N,2) ring -> closed list of Point2d (first vertex repeated last)."""
    ring = np.asarray(shape)
    if not np.allclose(ring[0], ring[-1]):
        ring = np.vstack([ring, ring[:1]])
    return [Point2d(x=p[0], y=p[1]) for p in ring]


def load_room_shape_polygon_from_predictions(
    room_shape_pred: List[Any],
    uncertainty=None,
    camera_height: float = DEFAULT_CAMERA_HEIGHT,
):
    """Alternating-corner uv list -> floor-plane polygon ((N,2) ring).

    Every second corner is a floor corner (the reference's `flag` toggle);
    with uncertainty, also returns the same boundary shifted up by the
    per-column uncertainty, for wall-confidence estimation.
    """
    flag = True
    uvs, uvs_upper = [], []
    for i, corner in enumerate(room_shape_pred):
        if not flag:
            uvs.append(
                [corner[0] + 0.5 / IMAGE_WIDTH_PX, corner[1] + 0.5 / IMAGE_HEIGHT_PX]
            )
            if uncertainty:
                uvs_upper.append(
                    [
                        corner[0] + 0.5 / IMAGE_WIDTH_PX,
                        corner[1] + 0.5 / IMAGE_HEIGHT_PX - uncertainty[i] / IMAGE_HEIGHT_PX,
                    ]
                )
        flag = not flag
    xys = np.array(transform_utils.uv_to_xy_batch(uvs, camera_height))
    if uncertainty:
        xys_upper = np.array(transform_utils.uv_to_xy_batch(uvs_upper, camera_height))
        return xys, xys_upper
    return xys


def generate_dense_shape(v_vals: List[Any], uncertainty: Any) -> Tuple[np.ndarray, List[float]]:
    """1024-wide floor boundary + uncertainty -> dense polygon + wall distances.

    Returns ((1024,2) ring, per-vertex uncertainty distance in meters).
    """
    vs = np.asarray(v_vals) / IMAGE_HEIGHT_PX
    us = np.arange(IMAGE_WIDTH_PX) / IMAGE_WIDTH_PX
    uvs = [[us[i], vs[i]] for i in range(IMAGE_WIDTH_PX)]
    polygon, poly_upper = load_room_shape_polygon_from_predictions(uvs, uncertainty)
    distances = list(np.linalg.norm(poly_upper - polygon, axis=1))
    return polygon, distances


def group_panos_by_room(
    predictions: Dict[Any, np.ndarray], location_panos: Dict[Any, Pose], device: DeviceLike = None
) -> List[List[Any]]:
    """Cluster panos into rooms by global layout overlap (parity :124)."""
    from salve_tpu_torch.algorithms.room_merging import _pairwise_overlap

    dev = resolve_device(device)
    shapes_global = {}
    graph = Graph()
    for panoid, pose in location_panos.items():
        ring = np.asarray(predictions[panoid])
        pts = [
            transform_utils.transform_xy_by_pose(Point2d(x=p[0], y=p[1]), pose)
            for p in ring
        ]
        shapes_global[panoid] = np.array([[p.x, p.y] for p in pts])
        graph.add_nodes_from([panoid])

    panoids = list(location_panos.keys())
    for i in range(len(panoids)):
        for j in range(i, len(panoids)):
            p1, p2 = panoids[i], panoids[j]
            iou, r1, r2 = _pairwise_overlap(shapes_global[p1], shapes_global[p2], device=dev)
            if (
                iou > MIN_LAYOUT_OVERLAP_IOU
                or r1 > MIN_LAYOUT_OVERLAP_RATIO
                or r2 > MIN_LAYOUT_OVERLAP_RATIO
            ):
                graph.add_edges_from([(p1, p2)])
    return [[*c] for c in sorted(connected_components(graph))]


def refine_shape_group_start_with(
    group: List[Any],
    start_id: Any,
    predicted_shapes: Dict[Any, np.ndarray],
    wall_confidences: Dict[Any, np.ndarray],
    location_panos: Dict[Any, Pose],
) -> Tuple[List[Point2d], List[float]]:
    """Fuse the room boundary seen from `start_id` using all group members.

    For each texture column of the reference pano, keep the wall estimate
    with the best (lowest-uncertainty) confidence among all panos whose
    reprojected boundary covers that column (parity :167-265).
    """
    RES = IMAGE_HEIGHT_PX
    original_us = np.arange(0.5 / RES, (RES + 0.5) / RES, 1.0 / RES)
    panoid = start_id
    current_shape = predicted_shapes[panoid]
    xys0 = extract_coordinates_from_polygon(current_shape)
    pose0 = location_panos[panoid]
    wall_conf0 = wall_confidences[panoid]
    uvs0 = [transform_utils.xy_to_uv(xy0, DEFAULT_CAMERA_HEIGHT) for xy0 in xys0]

    final_vs_all: Dict[Any, np.ndarray] = {}
    final_cs_all: Dict[Any, np.ndarray] = {}
    for panoid_1 in group:
        if panoid_1 == panoid:
            continue
        shape1 = predicted_shapes[panoid_1]
        pose1 = location_panos[panoid_1]
        wall_conf1 = wall_confidences[panoid_1]

        xys1 = extract_coordinates_from_polygon(shape1)
        xys1_projected, uvs1_projected = [], []
        for xy1 in xys1:
            xy1_t = transform_utils.transform_xy_by_pose(xy1, pose1)
            xy1_p = transform_utils.project_xy_by_pose(xy1_t, pose0)
            xys1_projected.append(xy1_p)
            uvs1_projected.append(transform_utils.xy_to_uv(xy1_p, DEFAULT_CAMERA_HEIGHT))

        ring = np.array([[p.x, p.y] for p in xys1_projected])
        # Only fuse panos whose reprojected shape contains the reference camera.
        if not bool(points_in_polygon(ring, np.zeros((1, 2)))[0]):
            continue

        final_vs, final_cs = transform_utils.reproject_uvs_to(
            uvs1_projected, wall_conf1, panoid_1, start_id
        )
        final_vs_all[panoid_1] = final_vs
        final_cs_all[panoid_1] = final_cs

    xys1_final: List[Point2d] = []
    conf1_final: List[float] = []
    for i, u in enumerate(original_us):
        v = uvs0[i].y
        current_c = wall_conf0[i]
        for panoid_new in final_vs_all:
            if current_c > final_cs_all[panoid_new][i] and final_vs_all[panoid_new][i] != 0:
                v = final_vs_all[panoid_new][i]
                current_c = final_cs_all[panoid_new][i]
        xy1_final = transform_utils.uv_to_xy(Point2d(x=u, y=v), DEFAULT_CAMERA_HEIGHT)
        xys1_final.append(Point2d(x=xy1_final.x, y=xy1_final.y))
        # Discontinuities signal unreliable columns.
        if i > 0 and xys1_final[i - 1].distance(xy1_final) > 0.03:
            current_c = 0
        conf1_final.append(current_c)
    return xys1_final, conf1_final


def refine_predicted_shape(
    groups: List[List[Any]],
    predicted_shapes: Dict[Any, np.ndarray],
    wall_confidences: Dict[Any, np.ndarray],
    location_panos: Dict[Any, Pose],
    cluster_dir: Optional[str] = None,
    tour_dir: Optional[str] = None,
):
    """Refine every room's shape (parity :266).

    Returns:
        shape_fused_by_cluster: per group, list of (fused Point2d boundary,
            confidences, reference pose) per member pano.
        fused_polygons: per group, list of fused global-frame (N,2) rings
            (the reference returned their Shapely cascaded union; consumers
            needing a raster union can use rasterize_polygons_union).
    """
    shape_fused_by_cluster = []
    fused_polygons: List[List[np.ndarray]] = []
    for group in groups:
        shape_fused_by_group = []
        group_polys = []
        for panoid in group:
            xys_fused, conf_fused = refine_shape_group_start_with(
                group, panoid, predicted_shapes, wall_confidences, location_panos
            )
            pose0 = location_panos[panoid]
            shape_fused_by_group.append([xys_fused, conf_fused, pose0])
            ring = np.array(
                [
                    [p.x, p.y]
                    for p in (
                        transform_utils.transform_xy_by_pose(xy, pose0)
                        for xy in xys_fused
                    )
                ]
            )
            group_polys.append(ring)
        shape_fused_by_cluster.append(shape_fused_by_group)
        fused_polygons.append(group_polys)
    return shape_fused_by_cluster, fused_polygons


def _build_raster_grid(
    all_pts: np.ndarray, resolution: float
) -> Tuple[np.ndarray, np.ndarray, float, float, np.ndarray]:
    """Pixel-center grid covering the points' bbox (capped at 4000^2 cells).

    Returns (xs, ys, sx, sy, mins) — the single source of truth for the
    grid convention shared by iou_between_polygon_sets and
    rasterize_polygons_union.
    """
    mins = all_pts.min(axis=0) - resolution
    maxs = all_pts.max(axis=0) + resolution
    nx_ = min(max(int(np.ceil((maxs[0] - mins[0]) / resolution)), 1), 4000)
    ny_ = min(max(int(np.ceil((maxs[1] - mins[1]) / resolution)), 1), 4000)
    sx = (maxs[0] - mins[0]) / nx_
    sy = (maxs[1] - mins[1]) / ny_
    xs = mins[0] + (np.arange(nx_) + 0.5) * sx
    ys = mins[1] + (np.arange(ny_) + 0.5) * sy
    return xs, ys, sx, sy, mins


def _union_mask_on_grid(
    polys: List[np.ndarray], xs: np.ndarray, ys: np.ndarray, device: torch.device
) -> torch.Tensor:
    """(H,W) bool union of rings, containment-tested per-ring bbox only,
    on `device`."""
    nx_, ny_ = len(xs), len(ys)
    mask = torch.zeros((ny_, nx_), dtype=torch.bool, device=device)
    xs_t = torch.as_tensor(xs, device=device)
    ys_t = torch.as_tensor(ys, device=device)
    for ring in polys:
        ring = np.asarray(ring)
        c0, c1 = np.searchsorted(xs, [ring[:, 0].min(), ring[:, 0].max()])
        r0, r1 = np.searchsorted(ys, [ring[:, 1].min(), ring[:, 1].max()])
        c1, r1 = min(c1 + 1, nx_), min(r1 + 1, ny_)
        if c0 >= c1 or r0 >= r1:
            continue
        ring_t = torch.as_tensor(ring, dtype=torch.float64, device=device)
        mask[r0:r1, c0:c1] |= points_in_polygon_grid(ring_t, xs_t[c0:c1], ys_t[r0:r1])
    return mask


def iou_between_polygon_sets(
    polys_a: List[np.ndarray],
    polys_b: List[np.ndarray],
    resolution: float = 0.02,
    device: DeviceLike = None,
) -> Dict[str, float]:
    """Raster IoU between the unions of two polygon sets on a shared grid.

    GEOS-free replacement for the reference's Shapely
    ``poly_gt_union.intersection(floor_shape_fused_poly)`` stitch-score
    arithmetic (scripts/stitch_floor_plan.py:228-233). Areas are in squared
    world units (pixel count x resolution^2).
    """
    dev = resolve_device(device)
    rings = [np.asarray(r) for r in polys_a + polys_b]
    if not rings:
        # Both sets empty (e.g. a cluster with no usable predictions and no
        # floor-map match): score 0, don't crash the stitch run.
        return {
            "iou": 0.0, "area_a": 0.0, "area_b": 0.0,
            "area_intersection": 0.0, "area_union": 0.0,
        }
    xs, ys, sx, sy, _ = _build_raster_grid(np.vstack(rings), resolution)
    mask_a = _union_mask_on_grid(polys_a, xs, ys, dev)
    mask_b = _union_mask_on_grid(polys_b, xs, ys, dev)
    px_area = sx * sy
    counts = torch.stack([(mask_a & mask_b).sum(), (mask_a | mask_b).sum(), mask_a.sum(), mask_b.sum()]).tolist()
    inter = float(counts[0]) * px_area
    union = float(counts[1]) * px_area
    return {
        "iou": inter / union if union > 0 else 0.0,
        "area_a": float(counts[2]) * px_area,
        "area_b": float(counts[3]) * px_area,
        "area_intersection": inter,
        "area_union": union,
    }


def rasterize_polygons_union(
    polygons: List[np.ndarray], resolution: float = 0.02, device: DeviceLike = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Occupancy raster of the union of (N,2) rings, rasterized on `device`.

    Returns (mask (H,W) bool numpy, origin (2,) world coords of pixel [0,0]).
    """
    dev = resolve_device(device)
    xs, ys, _, _, mins = _build_raster_grid(np.vstack(polygons), resolution)
    return _union_mask_on_grid(polygons, xs, ys, dev).cpu().numpy(), mins
