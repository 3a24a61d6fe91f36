"""uv <-> xy <-> depth conversions, pose transforms, ray casting.

Parity: salve/stitching/transform.py, with Shapely's LineString machinery
replaced by vectorized numpy segment intersection: a ray cast against an
N-edge polygon is one broadcasted solve over all edges, and the per-column
reprojection loop operates on whole arrays.

Conventions (FMA room-shape CS): clockwise rotation, u=0 at the pano's
left edge, camera at the origin at height `height` above the floor.

A copy of salve_tpu/stitching/transform.py (no JAX).
"""

from __future__ import annotations

import math
from typing import Any, List, Optional, Tuple

import numpy as np

from salve_tpu_torch.stitching.models import Point2d, Point3d, Pose


def rotate_xys_clockwise(xys: List[Point2d], rotation_deg: float) -> List[Point2d]:
    """Rotate points around the origin clockwise by rotation_deg."""
    arr = np.array([[p.x, p.y] for p in xys])
    r = math.radians(rotation_deg)
    R = np.array([[math.cos(-r), -math.sin(-r)], [math.sin(-r), math.cos(-r)]])
    out = arr @ R.T
    return [Point2d(x=p[0], y=p[1]) for p in out]


def uv_to_xyz(uv: Point2d) -> Point3d:
    """Texture coordinate -> unit-sphere direction (z up, clockwise)."""
    theta = math.pi - uv.y * math.pi
    phi = ((uv.x + 0.5) % 1.0) * math.pi * 2.0
    return Point3d(
        x=math.sin(theta) * math.sin(phi),
        y=math.sin(theta) * math.cos(phi),
        z=-math.cos(theta),
    )


def u_to_xy(u: float) -> Point2d:
    """Unit direction in the floor plane for texture column u."""
    phi = ((u + 0.5) % 1.0) * math.pi * 2.0
    return Point2d(x=math.sin(phi), y=math.cos(phi))


def uv_to_xy(uv: Point2d, height: float) -> Point2d:
    """Texture coordinate -> floor-plane point, given camera height."""
    xyz = uv_to_xyz(uv)
    scale = -height / xyz.z
    return Point2d(x=xyz.x * scale, y=xyz.y * scale)


def uv_to_xy_batch(uvs: List[Any], height: float) -> List[Any]:
    """Vectorized uv -> floor xy for a list of [u, v] pairs."""
    uvs_arr = np.asarray(uvs, dtype=np.float64)
    theta = math.pi - uvs_arr[:, 1] * math.pi
    phi = ((uvs_arr[:, 0] + 0.5) % 1.0) * math.pi * 2.0
    x = np.sin(theta) * np.sin(phi)
    y = np.sin(theta) * np.cos(phi)
    z = -np.cos(theta)
    scale = -height / z
    return [[xi, yi] for xi, yi in zip(x * scale, y * scale)]


def xy_to_u(xy: Point2d) -> float:
    """Floor point -> horizontal texture coordinate u in [0,1]."""
    return (math.atan2(xy.x, xy.y) / math.pi + 1.0) / 2.0


def xy_to_depth(xy: Point2d) -> float:
    return math.sqrt(xy.x * xy.x + xy.y * xy.y)


def xy_to_uv(xy: Point2d, height: float) -> Point2d:
    """Floor point -> texture coordinate, given camera height."""
    u = xy_to_u(xy)
    depth = np.linalg.norm((xy.x, xy.y))
    v = 1.0 - math.atan2(depth, height) / math.pi
    return Point2d(x=u, y=v)


def transform_xy_by_pose(xy: Point2d, pose: Pose) -> Point2d:
    """Rotate clockwise about the origin, then translate by the pose."""
    r = math.radians(-pose.rotation)
    x_rot = xy.x * math.cos(r) - xy.y * math.sin(r)
    y_rot = xy.x * math.sin(r) + xy.y * math.cos(r)
    return Point2d(x=x_rot + pose.position.x, y=y_rot + pose.position.y)


def project_xy_by_pose(xy: Point2d, pose: Pose) -> Point2d:
    """Inverse of transform_xy_by_pose: world point -> pose's camera frame."""
    xt = xy.x - pose.position.x
    yt = xy.y - pose.position.y
    r = math.radians(pose.rotation)
    return Point2d(
        x=xt * math.cos(r) - yt * math.sin(r), y=xt * math.sin(r) + yt * math.cos(r)
    )


# ---------------------------------------------------------------------------
# Ray casting / segment intersection without GEOS.
# ---------------------------------------------------------------------------


def _ray_segments_intersection(
    origin: np.ndarray, direction: np.ndarray, seg_a: np.ndarray, seg_b: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Intersect one ray with N segments at once.

    Returns (t_ray (N,), hit (N,)): distance along the ray per segment.
    """
    d = direction
    e = seg_b - seg_a  # (N,2)
    denom = d[0] * (-e[:, 1]) - d[1] * (-e[:, 0])
    rhs = seg_a - origin
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (rhs[:, 0] * (-e[:, 1]) - rhs[:, 1] * (-e[:, 0])) / denom
        s = (d[0] * rhs[:, 1] - d[1] * rhs[:, 0]) / denom
    hit = (np.abs(denom) > 1e-15) & (t > 1e-9) & (s >= -1e-4) & (s <= 1 + 1e-4)
    return t, hit


def ray_cast_by_u(u: float, shape: np.ndarray) -> Optional[Point2d]:
    """Closest intersection of the u-direction ray with a polygon boundary.

    Args:
        u: texture column defining the ray direction from the origin.
        shape: (N,2) closed or open polygon ring.

    Returns:
        Closest hit as Point2d, or None.
    """
    xy = u_to_xy(u)
    direction = np.array([xy.x, xy.y])
    ring = np.asarray(shape, dtype=np.float64)
    if not np.allclose(ring[0], ring[-1]):
        ring = np.vstack([ring, ring[:1]])
    t, hit = _ray_segments_intersection(
        np.zeros(2), direction, ring[:-1], ring[1:]
    )
    if not hit.any():
        return None
    t_min = t[hit].min()
    p = direction * t_min
    return Point2d(x=p[0], y=p[1])


def line_segment_intersection(
    line1: Tuple[np.ndarray, np.ndarray],
    line2: Tuple[np.ndarray, np.ndarray],
    buffer_size: float = 1e-4,
) -> Optional[Point2d]:
    """Intersection of two segments (each an (a, b) endpoint pair), with a
    small buffer tolerance at the endpoints (parity :266)."""
    a1, b1 = (np.asarray(p, dtype=np.float64) for p in line1)
    a2, b2 = (np.asarray(p, dtype=np.float64) for p in line2)
    d1, d2 = b1 - a1, b2 - a2
    denom = d1[0] * (-d2[1]) - d1[1] * (-d2[0])
    if abs(denom) < 1e-15:
        return None
    rhs = a2 - a1
    t = (rhs[0] * (-d2[1]) - rhs[1] * (-d2[0])) / denom
    s = (d1[0] * rhs[1] - d1[1] * rhs[0]) / denom
    p = a1 + t * d1

    def _near(pt, a, b):
        e = b - a
        L2 = float(e @ e)
        tt = 0.0 if L2 == 0 else np.clip((pt - a) @ e / L2, 0, 1)
        return float(np.linalg.norm(pt - (a + tt * e))) < buffer_size

    if _near(p, a1, b1) and _near(p, a2, b2):
        return Point2d(x=p[0], y=p[1])
    return None


# ---------------------------------------------------------------------------
# Homogeneous 2D transforms (parity :327-392).
# ---------------------------------------------------------------------------


def gen_homogeneous_transformation_matrix_for_2d(
    shift: Any, rot_rad: float, scale: float
) -> np.ndarray:
    """Scale -> rotation -> translation as a 3x3 homogeneous matrix."""
    mat_scale = np.array([[scale, 0, 0], [0, scale, 0], [0, 0, 1]])
    mat_rot = np.array(
        [
            [np.cos(rot_rad), -np.sin(rot_rad), 0],
            [np.sin(rot_rad), np.cos(rot_rad), 0],
            [0, 0, 1],
        ]
    )
    mat_translate = np.array([[1, 0, shift[0]], [0, 1, shift[1]], [0, 0, 1]])
    return mat_translate @ mat_rot @ mat_scale


def generate_2d_tranformation_matrix_from_room_to_floor(
    x: float, y: float, rotation: float, scale: float = 1.0
) -> np.ndarray:
    """room-shape CS (left-handed) -> floor-shape CS (right-handed)."""
    return gen_homogeneous_transformation_matrix_for_2d(
        [-x, y], np.deg2rad(-rotation), scale
    )


def transform_xz(mat_transform_2d: np.ndarray, xzs: List[Any]) -> List[Any]:
    arr = np.ones((len(xzs), 3))
    arr[:, :2] = np.asarray(xzs)[:, :2]
    out = arr @ mat_transform_2d.T
    return [[p[0], p[1]] for p in out]


def get_global_coords_2d_from_room_cs(
    pano_xy: Any, x: Any, y: Any, rotation: Any, scale: float = 1
) -> Any:
    mat = generate_2d_tranformation_matrix_from_room_to_floor(x, y, rotation, scale)
    return transform_xz(mat, [[pano_xy[0], pano_xy[1]]])


# ---------------------------------------------------------------------------
# Cross-pano boundary reprojection (parity :394-470).
# ---------------------------------------------------------------------------


def reproject_uvs_to(
    uvs1_projected: List[Point2d], wall_conf1: np.ndarray, panoid, start_id
) -> Tuple[np.ndarray, np.ndarray]:
    """Resample a reprojected boundary onto the reference pano's u-columns.

    The projected boundary wraps nonmonotonically in u; split it into
    monotonic sections, interpolate v and confidence per section onto the
    512 regular u-columns, and keep the largest v (closest wall) per column.

    Returns (final_vs (512,), final_cs (512,)).
    """
    RES = 512
    us_projected = np.array([uv.x for uv in uvs1_projected])
    us_prev = np.concatenate([[0], us_projected[:-1]])
    direction = (us_projected - us_prev) > 0

    start = 0
    changes = []
    for j in range(RES):
        if direction[j] != direction[j + 1]:
            changes.append([start, j])
            start = j + 1
    if not changes:
        changes = [[0, RES - 1]]
    if changes[-1][1] != RES - 1:
        changes.append([start, RES - 1])
    if len(changes) > 1 and direction[0] != direction[1]:
        changes = changes[1:]
        changes[0][0] = 0

    sections = [changes[0]]
    for change in changes[1:]:
        if change[1] - change[0] < 2:
            continue
        sections.append(change)

    original_us = np.arange(0.5 / RES, (RES + 0.5) / RES, 1.0 / RES)
    final_vs = np.zeros(RES)
    final_cs = np.zeros(RES)
    for section in sections:
        us = np.array([uv.x for uv in uvs1_projected[section[0] : section[1] + 1]])
        vs = np.array([uv.y for uv in uvs1_projected[section[0] : section[1] + 1]])
        confs = np.asarray(wall_conf1[section[0] : section[1] + 1])
        if us.size < 2:
            continue

        order = np.argsort(us)
        us_s, vs_s, cs_s = us[order], vs[order], confs[order]

        is_polarized = False
        if us.min() < 0.1 and us.max() > 0.9:
            us_low = us[us < 0.5]
            us_high = us[us > 0.5]
            if us_high.size and us_low.size and us_high.min() - us_low.max() > 0.1:
                is_polarized = True

        start_u_idx = math.ceil((us.min() - 0.5 / RES) / (1 / RES))
        end_u_idx = math.floor((us.max() - 0.5 / RES) / (1 / RES))
        if not is_polarized:
            ranges = [[start_u_idx, end_u_idx]]
        else:
            ranges = [[0, start_u_idx], [end_u_idx, RES - 1]]

        for s_idx, e_idx in ranges:
            s_idx = max(s_idx, 0)
            e_idx = min(e_idx, RES - 1)
            if e_idx < s_idx:
                continue
            us_new = original_us[s_idx : e_idx + 1]
            inside = (us_new >= us_s[0]) & (us_new <= us_s[-1])
            if not inside.any():
                continue
            new_vs = np.interp(us_new, us_s, vs_s)
            new_cs = np.interp(us_new, us_s, cs_s)
            new_vs = np.where(inside, new_vs, 0.0)
            new_cs = np.where(inside, new_cs, 0.0)
            cur_v = final_vs[s_idx : e_idx + 1]
            does_update = ((cur_v == 0) | (new_vs > cur_v)) & inside
            final_vs[s_idx : e_idx + 1] = np.where(does_update, new_vs, cur_v)
            final_cs[s_idx : e_idx + 1] = np.where(
                does_update, new_cs, final_cs[s_idx : e_idx + 1]
            )
    return final_vs, final_cs


def ray_cast_and_generate_dwo_xy(dwo_pred: Any, shape: np.ndarray):
    """Ray-cast the two u-bounds of a W/D/O onto the room shape."""
    return [ray_cast_by_u(dwo_pred[0], shape), ray_cast_by_u(dwo_pred[1], shape)]
