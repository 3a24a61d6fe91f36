"""Polygon predicates without GEOS: containment, boundary distance, erosion.

Replaces the reference's Shapely usage in salve/utils/overlap_utils.py.

Key identity used for polygon shrinking: a query point lies inside
``polygon.buffer(-d)`` iff it lies inside the polygon AND its distance to the
polygon boundary exceeds ``d`` (morphological erosion). This turns the
reference's "build shrunk polygon, then test containment" into two vectorized
predicates with static shapes. (Difference from
GEOS: when erosion splits a polygon into multiple components the reference
keeps only the largest one; the erosion predicate keeps all components. This
can only admit extra violation counts in degenerate concave layouts, making
the validity check at most stricter.)

Every function is NumPy on the host; GT mode's freespace check runs here.

A copy of salve_tpu/geometry/polygons.py (no JAX).
"""

from __future__ import annotations

import numpy as np

from salve_tpu_torch.geometry.polylines import interp_evenly_spaced_points

EPS = 1e-9


def points_in_polygon(polygon: np.ndarray, query: np.ndarray) -> np.ndarray:
    """Even-odd (crossing-number) point-in-polygon test, vectorized.

    Args:
        polygon: (M,2) vertices (closed or open ring; closure is implicit).
        query: (N,2) query points.

    Returns:
        (N,) boolean array; boundary points are implementation-defined
        (GEOS `contains` excludes the boundary; violations on the exact
        boundary are measure-zero for real layouts).
    """
    px = polygon[:, 0]
    py = polygon[:, 1]
    qx = query[:, 0][:, None]  # (N,1)
    qy = query[:, 1][:, None]
    x1, y1 = px[None, :], py[None, :]  # (1,M) edge starts
    x2, y2 = np.roll(px, -1)[None, :], np.roll(py, -1)[None, :]  # edge ends
    # Edge straddles the horizontal ray through qy.
    straddles = (y1 > qy) != (y2 > qy)
    # x-coordinate where the edge crosses the ray.
    denom = y2 - y1
    denom = np.where(denom == 0, 1.0, denom)
    x_cross = x1 + (qy - y1) * (x2 - x1) / denom
    crossings = np.sum(straddles & (qx < x_cross), axis=1)
    return (crossings % 2) == 1


def distance_to_boundary(polygon: np.ndarray, query: np.ndarray) -> np.ndarray:
    """Min distance from each query point to the polygon's boundary edges.

    Args:
        polygon: (M,2) ring vertices (implicit closure).
        query: (N,2) points.

    Returns:
        (N,) distances.
    """
    a = polygon  # (M,2)
    b = np.roll(polygon, -1, axis=0)
    ab = b - a  # (M,2)
    ab_len2 = np.sum(ab**2, axis=1)  # (M,)
    ab_len2 = np.where(ab_len2 == 0, 1.0, ab_len2)
    aq = query[:, None, :] - a[None, :, :]  # (N,M,2)
    t = np.clip(np.sum(aq * ab[None, :, :], axis=2) / ab_len2[None, :], 0.0, 1.0)
    closest = a[None, :, :] + t[..., None] * ab[None, :, :]
    d = np.linalg.norm(query[:, None, :] - closest, axis=2)
    return d.min(axis=1)


def shrink_distance_for_polygon(polygon: np.ndarray, shrink_factor: float) -> float:
    """Erosion radius used by the reference's shrink_polygon.

    Defined as shrink_factor times the distance from the polygon's
    axis-aligned bounding-box center to the bbox min corner
    (salve/utils/overlap_utils.py:15-36).
    """
    xs, ys = polygon[:, 0], polygon[:, 1]
    center = np.array([0.5 * xs.min() + 0.5 * xs.max(), 0.5 * ys.min() + 0.5 * ys.max()])
    min_corner = np.array([xs.min(), ys.min()])
    return float(np.linalg.norm(center - min_corner) * shrink_factor)


def count_verts_inside_shrunk_poly(
    polygon: np.ndarray, query_verts: np.ndarray, shrink_dist: float
) -> int:
    """Count query points strictly inside the polygon eroded by `shrink_dist`."""
    inside = points_in_polygon(polygon, query_verts)
    far_enough = distance_to_boundary(polygon, query_verts) > shrink_dist
    return int(np.sum(inside & far_enough))


def determine_invalid_wall_overlap(
    pano1_room_vertices: np.ndarray,
    pano2_room_vertices: np.ndarray,
    shrink_factor: float,
    **_ignored,
) -> bool:
    """Check that neither room's walls penetrate the other room's freespace.

    Parity: salve/utils/overlap_utils.py:67. Boundary points of each room
    (densely resampled at 0.1 in normalized room coordinates) may not fall
    inside a shrunken version of the other room's polygon. Rooms overlapping
    is fine (same-room panos do); walls *inside* freespace are not.

    Returns:
        is_valid: True if zero freespace violations.
    """
    p1 = np.vstack([pano1_room_vertices, pano1_room_vertices[0] + EPS])
    p2 = np.vstack([pano2_room_vertices, pano2_room_vertices[0] + EPS])

    p1_interp = interp_evenly_spaced_points(p1, interval_m=0.1)
    p2_interp = interp_evenly_spaced_points(p2, interval_m=0.1)

    d1 = shrink_distance_for_polygon(p1, shrink_factor)
    d2 = shrink_distance_for_polygon(p2, shrink_factor)

    violations = count_verts_inside_shrunk_poly(p1, p2_interp, d1)
    violations += count_verts_inside_shrunk_poly(p2, p1_interp, d2)
    return violations == 0


def polygon_area(polygon: np.ndarray) -> float:
    """Shoelace area (absolute value) of an (M,2) ring."""
    x, y = polygon[:, 0], polygon[:, 1]
    x2, y2 = np.roll(x, -1), np.roll(y, -1)
    return float(0.5 * np.abs(np.sum(x * y2 - x2 * y)))


def polygon_iou_and_overlap(poly_a: np.ndarray, poly_b: np.ndarray, resolution: float = 0.02):
    """Raster IoU and smaller-polygon overlap-ratio between two polygons.

    Used by room grouping (reference uses Shapely's exact intersection;
    a fine raster over the union bbox is an XLA-friendly equivalent).

    Returns:
        (iou, overlap_ratio) where overlap_ratio = |A∩B| / min(|A|, |B|).
    """
    mins = np.minimum(poly_a.min(axis=0), poly_b.min(axis=0)) - resolution
    maxs = np.maximum(poly_a.max(axis=0), poly_b.max(axis=0)) + resolution
    nx = max(int(np.ceil((maxs[0] - mins[0]) / resolution)), 1)
    ny = max(int(np.ceil((maxs[1] - mins[1]) / resolution)), 1)
    nx, ny = min(nx, 2000), min(ny, 2000)
    xs = mins[0] + (np.arange(nx) + 0.5) * (maxs[0] - mins[0]) / nx
    ys = mins[1] + (np.arange(ny) + 0.5) * (maxs[1] - mins[1]) / ny
    grid = np.stack(np.meshgrid(xs, ys), axis=-1).reshape(-1, 2)
    in_a = points_in_polygon(poly_a, grid)
    in_b = points_in_polygon(poly_b, grid)
    inter = float(np.sum(in_a & in_b))
    union = float(np.sum(in_a | in_b))
    area_a, area_b = float(np.sum(in_a)), float(np.sum(in_b))
    iou = inter / union if union > 0 else 0.0
    overlap = inter / min(area_a, area_b) if min(area_a, area_b) > 0 else 0.0
    return iou, overlap
