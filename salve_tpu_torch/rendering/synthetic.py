"""Synthetic equirect panos ray-cast from room layouts: the numpy copy of
salve_tpu/rendering/synthetic.py.

`raycast_layout` casts every pano ray against a vertical-prism room (floor
polygon, camera and ceiling heights) and returns exact metric depth along
each ray; `render_synthetic_pano` textures the same cast into an RGB pano.
Together they supervise and measure the depth net without real imagery
(`training/depth.py`, `models/depth_net.py:synthesize_depth_from_layout`).

The floor world (`FloorWorld`, `build_floor_world`, `raycast_floor_world`,
`render_synthetic_pano_world`) casts through every room of a floor at once,
with doors and openings as transparent portals, so panos of adjacent rooms
share visible content: `dataset/synthetic_zind.py` materializes buildings
with it. Its textures are the single-room render's, drawn in the same order.

The copy is numpy float64, as the original is. Its ray grid is
`uni_sphere_xyz_f64`, a float64 numpy grid equal to
salve_tpu/geometry/pano_projection.py:157, and not the port's
`geometry/pano_projection.py:get_uni_sphere_xyz` (a float32 torch grid on
glibc's sinf/cosf for the backprojection): with it the casts equal the
original's bit for bit. The floor world's K nearest wall crossings are
chosen with numpy's `argpartition` and `argsort`, as the original chooses
them, so ties break alike.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np


def uni_sphere_xyz_f64(H: int, W: int) -> np.ndarray:
    """(H, W, 3) float64 unit-sphere ray grid in the HoHoNet convention:
    u spans the width with a half-pixel offset, v the height; x right,
    y down-ish, z up (salve_tpu/geometry/pano_projection.py:157)."""
    jj, ii = np.meshgrid(np.arange(H) * 1.0, np.arange(W) * 1.0, indexing="ij")
    u = -(ii + 0.5) / W * 2 * math.pi
    v = ((jj + 0.5) / H - 0.5) * math.pi
    z = -np.sin(v)
    c = np.cos(v)
    y = c * np.sin(u)
    x = c * np.cos(u)
    return np.stack([x, y, z], axis=-1)


PANO_H, PANO_W = 512, 1024

FLOOR, CEILING, WALL = 0, 1, 2

# ZInD ego frame vs pano sphere frame (salve_tpu/rendering/synthetic.py:45):
# the backprojection maps a real pano's sphere-frame directions into the ego
# frame with a -90 deg rotation, so every pose-driven render bakes in the
# inverse: R_render(sphere->world) = R_ego_to_world @ R_FIX.
R_FIX = np.array([[0.0, 1.0], [-1.0, 0.0]])


def raycast_layout(
    room_vertices_m: np.ndarray,
    camera_height_m: float,
    ceiling_height_m: float,
    h: int = PANO_H,
    w: int = PANO_W,
) -> Dict[str, np.ndarray]:
    """Cast every pano ray against a vertical-prism room model.

    The room is the prism over the floor polygon `room_vertices_m` (metric,
    camera at origin) between z=-camera_height_m (floor) and
    z=ceiling_height_m - camera_height_m (ceiling).

    Returns dict with:
        depth:    (h,w) metric distance along the ray to the first hit.
        surface:  (h,w) int8 in {FLOOR, CEILING, WALL}.
        hit_xyz:  (h,w,3) hit point, camera frame.
        wall_edge:(h,w) int32 polygon-edge index of wall hits (else -1).
        wall_s:   (h,w) metric arc length along that edge at the hit.
    """
    rays = uni_sphere_xyz_f64(h, w)  # (h,w,3), unit
    ring = np.asarray(room_vertices_m, dtype=np.float64)
    a = ring
    b = np.roll(ring, -1, axis=0)
    e = b - a  # (E,2)
    e_len = np.linalg.norm(e, axis=1)

    dx = rays[..., 0][..., None]
    dy = rays[..., 1][..., None]
    # Ray (t*dx, t*dy) meets segment a + s*e: solve the 2x2 system.
    denom = dx * (-e[:, 1]) + dy * e[:, 0]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (a[:, 0] * (-e[:, 1]) + a[:, 1] * e[:, 0]) / denom
        s = (dx * a[:, 1] - dy * a[:, 0]) / denom
    hit = (np.abs(denom) > 1e-12) & (t > 1e-6) & (s >= 0.0) & (s <= 1.0)
    t = np.where(hit, t, np.inf)
    edge_idx = np.argmin(t, axis=-1).astype(np.int32)  # (h,w)
    t_wall = np.take_along_axis(t, edge_idx[..., None], axis=-1)[..., 0]
    s_wall = np.take_along_axis(
        np.where(hit, s, 0.0), edge_idx[..., None], axis=-1
    )[..., 0]

    # t parametrizes the unit 3D ray directly (its xy components were used in
    # the 2D solve), so t_wall is already metric distance along the ray.
    t_wall_3d = t_wall

    dz = rays[..., 2]
    z_floor = -float(camera_height_m)
    z_ceil = float(ceiling_height_m) - float(camera_height_m)
    with np.errstate(divide="ignore", invalid="ignore"):
        t_floor = np.where(dz < -1e-6, z_floor / dz, np.inf)
        t_ceil = np.where(dz > 1e-6, z_ceil / dz, np.inf)

    # The wall hit only counts while its z lies within [floor, ceiling];
    # beyond that the floor/ceiling plane is hit first anyway because the
    # room is convex in z — min() implements exactly that.
    depth = np.minimum(np.minimum(t_floor, t_ceil), t_wall_3d)
    surface = np.where(
        depth == t_wall_3d, WALL, np.where(depth == t_floor, FLOOR, CEILING)
    ).astype(np.int8)
    depth = np.clip(depth, 0.0, 65.0)

    hit_xyz = rays * depth[..., None]
    wall_edge = np.where(surface == WALL, edge_idx, -1).astype(np.int32)
    wall_s = np.where(surface == WALL, s_wall * e_len[edge_idx], 0.0)
    return {
        "depth": depth.astype(np.float32),
        "surface": surface,
        "hit_xyz": hit_xyz.astype(np.float32),
        "wall_edge": wall_edge,
        "wall_s": wall_s.astype(np.float32),
    }


def _hash01(*ints: int) -> float:
    """Deterministic [0,1) hash of small integers (texture randomization)."""
    x = np.uint64(2166136261)
    for i in ints:
        x = np.uint64((int(x) ^ (int(i) & 0xFFFFFFFF)) * 16777619 & 0xFFFFFFFFFFFFFFFF)
    return float(int(x) % 100003) / 100003.0


def _hash01_grid(ix: np.ndarray, iy: np.ndarray, seed: int, salt: int) -> np.ndarray:
    """Vectorized [0,1) hash of integer grid coordinates."""
    h = (
        ix.astype(np.int64) * np.int64(73856093)
        ^ iy.astype(np.int64) * np.int64(19349663)
        ^ np.int64((seed * 31 + salt) * 83492791)
    )
    return (np.abs(h) % np.int64(100003)).astype(np.float64) / 100003.0


# Rug grid for world-anchored floor patches (see render_synthetic_pano).
RUG_CELL_M, RUG_MARGIN_M = 2.0, 0.3


SPECKLE_CELL_M = 0.3


def _speckle(wx, wy, seed: int, salt: int, amp: float):
    """High-frequency world-anchored brightness speckle (wood grain /
    surface-detail stand-in): a hashed 0.3 m cell grid decorrelates any
    offset beyond one cell."""
    sx = np.floor(wx / SPECKLE_CELL_M).astype(np.int64)
    sy = np.floor(wy / SPECKLE_CELL_M).astype(np.int64)
    return 1.0 - amp + 2.0 * amp * _hash01_grid(sx, sy, seed, salt)


def _apply_door_mats(floor_col, wx, wy, door_rects, seed: int):
    """World-anchored asymmetric "doormats" beside door/opening spans: each
    door's neighborhood gets a hashed mat whose side, hinge-end offset, size
    and color derive from the door's world position.

    `door_rects` is a list of world-frame (a_xy, b_xy) segments (doors and
    openings). Endpoints are canonicalized so coincident copies from
    different panos paint identical mats.
    """
    if not door_rects:
        return floor_col
    for a, b in door_rects:
        a = np.asarray(a, dtype=np.float64)
        b = np.asarray(b, dtype=np.float64)
        if (b[0], b[1]) < (a[0], a[1]):  # endpoint-order canonicalization
            a, b = b, a
        wvec = b - a
        wlen = float(np.linalg.norm(wvec))
        if wlen < 1e-6:
            continue
        along = wvec / wlen
        nrm = np.array([-along[1], along[0]])
        mid = (a + b) / 2.0
        kx, ky = int(round(mid[0] / 0.25)), int(round(mid[1] / 0.25))
        u = (wx - a[0]) * along[0] + (wy - a[1]) * along[1]
        v = (wx - a[0]) * nrm[0] + (wy - a[1]) * nrm[1]
        for side_salt in (71, 72):  # each side of the wall independently
            if _hash01(seed, kx, ky, side_salt) > 0.85:
                continue
            hinge_at_b = _hash01(seed, kx, ky, side_salt + 2) < 0.5
            mlen = (0.45 + 0.35 * _hash01(seed, kx, ky, side_salt + 3)) * wlen
            depth_m = 0.5 + 0.5 * _hash01(seed, kx, ky, side_salt + 4)
            u0 = wlen - mlen if hinge_at_b else 0.0
            u1 = u0 + mlen
            if side_salt == 71:
                v0, v1 = 0.06, 0.06 + depth_m
            else:
                v0, v1 = -0.06 - depth_m, -0.06
            m = (u >= u0) & (u <= u1) & (v >= v0) & (v <= v1)
            if not m.any():
                continue
            col = np.array(
                [
                    50.0 + 180.0 * _hash01(seed, kx, ky, side_salt + 5),
                    50.0 + 180.0 * _hash01(seed, kx, ky, side_salt + 6),
                    50.0 + 180.0 * _hash01(seed, kx, ky, side_salt + 7),
                ]
            )
            border = m & (
                (u < u0 + 0.08) | (u > u1 - 0.08) | (v < v0 + 0.08) | (v > v1 - 0.08)
            )
            floor_col = np.where(m[..., None], col, floor_col)
            floor_col = np.where(border[..., None], col * 0.55, floor_col)
    return floor_col


def _smooth_field(
    wx: np.ndarray, wy: np.ndarray, rng, amp: float = 0.22, n_waves: int = 2
) -> np.ndarray:
    """Smooth non-periodic per-channel color modulation, world-anchored.

    A mixture of random-frequency sinusoids (0.25-0.9 rad/m): every world
    location gets a distinct, slowly-varying tint, so two BEV crops agree
    only when they truly cover the same place.
    """
    field = np.ones(wx.shape + (3,))
    for c in range(3):
        acc = np.zeros_like(wx)
        for _ in range(n_waves):
            fx, fy = rng.uniform(0.25, 0.9, 2)
            px, py = rng.uniform(0, 2 * np.pi, 2)
            acc = acc + np.sin(wx * fx + px) * np.sin(wy * fy + py)
        field[..., c] = 1.0 + amp * acc / n_waves
    return field


def render_synthetic_pano(
    room_vertices_m: np.ndarray,
    camera_height_m: float,
    ceiling_height_m: Optional[float] = None,
    h: int = PANO_H,
    w: int = PANO_W,
    seed: int = 0,
    world_R: Optional[np.ndarray] = None,
    world_t: Optional[np.ndarray] = None,
    door_rects=None,
) -> Dict[str, np.ndarray]:
    """Textured synthetic pano + exact depth for a room layout.

    Textures are procedural but scale-anchored (0.5 m floor checker, 0.25 m
    wall stripes, baseboards, hashed wall hues), so both monocular depth
    cues and BEV texture matching carry real signal.

    Texture coordinates are WORLD-anchored when (world_R, world_t) — the
    metric camera->world transform — are given: two panos viewing the same
    room then render agreeing colors, which is exactly the signal the
    alignment verifier must learn (a per-pano texture world would make even
    GT-aligned pairs look inconsistent). With the default identity
    transform, textures are camera-anchored (fine for single-pano uses like
    depth-supervision domain randomization).

    Returns dict with 'rgb' (h,w,3) uint8 and everything raycast_layout emits.
    """
    if ceiling_height_m is None:
        ceiling_height_m = 2.0 * camera_height_m
    cast = raycast_layout(room_vertices_m, camera_height_m, ceiling_height_m, h, w)
    depth, surface = cast["depth"], cast["surface"]
    xyz = cast["hit_xyz"]

    if world_R is None:
        world_R = np.eye(2)
    if world_t is None:
        world_t = np.zeros(2)
    wxy = xyz[..., :2] @ np.asarray(world_R, dtype=np.float64).T + np.asarray(
        world_t, dtype=np.float64
    )
    wx, wy = wxy[..., 0], wxy[..., 1]
    wz = xyz[..., 2] + camera_height_m  # absolute height above the floor

    rng = np.random.default_rng(seed)
    rgb = np.zeros((h, w, 3), dtype=np.float64)

    # Floor: 0.5 m checkerboard over two warm wood tones + plank stripes.
    base_a = np.array([139, 105, 74]) + rng.integers(-15, 15, 3)
    base_b = np.array([168, 135, 100]) + rng.integers(-15, 15, 3)
    checker = ((np.floor(wx / 0.5) + np.floor(wy / 0.5)) % 2).astype(bool)
    plank = (np.floor(wy / 0.12) % 2).astype(bool)
    floor_col = np.where(checker[..., None], base_a, base_b) * np.where(
        plank[..., None], 1.0, 0.92
    )

    # World-anchored location distinguishers. Without them the floor is a
    # uniform *periodic* checker: BEV crops from different places look
    # statistically identical (and exactly identical modulo the 1 m period),
    # so misaligned overlaps carry no mismatch signal — measured as verifier
    # precision at chance on held-out buildings despite a healthy val mAcc.
    #  (a) smooth random color field: every location gets a distinct tint;
    #  (b) hashed 2 m "area rugs": salient distinct-color patches on ~40%
    #      of floor cells (furniture stand-in).
    field = _smooth_field(wx, wy, rng)
    floor_col = floor_col * field
    floor_col = floor_col * _speckle(wx, wy, seed, 23, 0.25)[..., None]
    ix = np.floor(wx / RUG_CELL_M).astype(np.int64)
    iy = np.floor(wy / RUG_CELL_M).astype(np.int64)
    has_rug = _hash01_grid(ix, iy, seed, 11) < 0.55
    fx_in = wx - ix * RUG_CELL_M
    fy_in = wy - iy * RUG_CELL_M
    in_rug = (
        has_rug
        & (fx_in > RUG_MARGIN_M) & (fx_in < RUG_CELL_M - RUG_MARGIN_M)
        & (fy_in > RUG_MARGIN_M) & (fy_in < RUG_CELL_M - RUG_MARGIN_M)
    )
    rug_col = np.stack(
        [60.0 + 160.0 * _hash01_grid(ix, iy, seed, s) for s in (5, 6, 7)], -1
    )
    rug_stripe = (np.floor((fx_in + fy_in) / 0.2) % 2).astype(bool)
    rug_col = rug_col * np.where(rug_stripe[..., None], 1.0, 0.9)
    floor_col = np.where(in_rug[..., None], rug_col, floor_col)
    floor_col = _apply_door_mats(floor_col, wx, wy, door_rects, seed)
    rgb = np.where((surface == FLOOR)[..., None], floor_col, rgb)

    # Ceiling: light neutral with a slow plaster gradient + the same
    # world-anchored field (lighter), so the ceiling modality also tells
    # locations apart.
    ceil_base = np.array([228, 226, 220]) + rng.integers(-8, 8, 3)
    grad = 1.0 - 0.05 * np.abs(np.sin(wx * 0.7) + np.cos(wy * 0.9)) / 2
    ceil_col = ceil_base * grad[..., None] * (1.0 + 0.6 * (field - 1.0))
    ceil_col = ceil_col * _speckle(wx, wy, seed, 29, 0.15)[..., None]
    rgb = np.where((surface == CEILING)[..., None], ceil_col, rgb)

    # Walls: hue hashed from the wall's quantized WORLD position (two panos
    # of one room hash the same physical wall to the same hue), 0.25 m
    # world-space stripes, baseboard + crown bands at absolute heights.
    edge = cast["wall_edge"]
    ring = np.asarray(room_vertices_m, dtype=np.float64)
    mids = 0.5 * (ring + np.roll(ring, -1, axis=0))  # (E,2) edge midpoints
    wmids = mids @ np.asarray(world_R, dtype=np.float64).T + np.asarray(
        world_t, dtype=np.float64
    )
    qm = np.round(wmids / 0.25).astype(np.int64)  # 0.25 m quantization
    n_edges = len(ring)
    hue_lut = np.array(
        [
            [
                140 + 90 * _hash01(seed, int(qm[k, 0]), int(qm[k, 1]), 1),
                140 + 90 * _hash01(seed, int(qm[k, 0]), int(qm[k, 1]), 2),
                130 + 90 * _hash01(seed, int(qm[k, 0]), int(qm[k, 1]), 3),
            ]
            for k in range(max(n_edges, 1))
        ]
    )
    wall_base = hue_lut[np.clip(edge, 0, n_edges - 1)]
    stripe = (np.floor((wx + wy) / 0.25) % 2).astype(bool)
    baseboard = wz < 0.12
    crown = wz > (ceiling_height_m - 0.10)
    wall_col = wall_base * np.where(stripe[..., None], 1.0, 0.90)
    wall_col = np.where(baseboard[..., None], np.array([70.0, 60, 55]), wall_col)
    wall_col = np.where(crown[..., None], np.array([210.0, 208, 200]), wall_col)
    rgb = np.where((surface == WALL)[..., None], wall_col, rgb)

    # Distance shading (cheap ambient falloff) + sensor noise.
    shade = 1.0 / (1.0 + 0.035 * depth)
    rgb = rgb * shade[..., None]
    rgb = rgb + rng.normal(0.0, 2.5, rgb.shape)
    out = dict(cast)
    out["rgb"] = np.clip(rgb, 0, 255).astype(np.uint8)
    return out


class FloorWorld:
    """Multi-room world model of one building floor, world-metric.

    Walls are the union of every room's polygon edges; door/opening spans
    are transparent "portals" so rays continue into the neighboring room —
    the physics that gives two panos in adjacent rooms SHARED visible floor
    and ceiling content. (Single-room raycasts render zero overlap for
    cross-room pano pairs, which removes exactly the texture-agreement
    signal the alignment verifier must learn; the reference's real panos
    see through open doors.) Windows stay opaque.
    """

    def __init__(self, rooms, seg_a, seg_b, portals, door_rects=None):
        self.rooms = rooms          # list of (V,2) world-metric polygons
        self.seg_a = seg_a          # (E,2) segment starts
        self.seg_b = seg_b          # (E,2) segment ends
        # portals[e] = list of (s_lo, s_hi, z_lo, z_hi) transparent spans on
        # segment e (arc-length meters along the segment, absolute z meters).
        self.portals = portals
        # Deduped world-metric (a_xy, b_xy) door/opening spans, for the v12
        # floor-mat asymmetry cues (_apply_door_mats).
        self.door_rects = door_rects or []


def build_floor_world(pose_graph) -> "FloorWorld":
    """FloorWorld from a GT pose graph (PoseGraph2d with metric scale)."""
    S = float(pose_graph.scale_meters_per_coordinate)
    rooms, seg_a, seg_b = [], [], []
    portal_rects = []  # (a_xy, b_xy, z_lo, z_hi) world-metric
    for pid, pano in pose_graph.nodes.items():
        cam_h = pose_graph.get_camera_height_m(pid)
        ring = np.asarray(pano.room_vertices_global_2d, dtype=np.float64) * S
        rooms.append(ring)
        a = ring
        b = np.roll(ring, -1, axis=0)
        seg_a.append(a)
        seg_b.append(b)
        for wdo in list(pano.doors or []) + list(pano.openings or []):
            pts = np.asarray(wdo.vertices_global_2d, dtype=np.float64) * S
            z_lo = (float(wdo.bottom_z) + 1.0) * cam_h
            z_hi = (float(wdo.top_z) + 1.0) * cam_h
            portal_rects.append((pts[0], pts[1], z_lo, z_hi))
    seg_a = np.concatenate(seg_a, axis=0)
    seg_b = np.concatenate(seg_b, axis=0)

    # Associate each portal with every wall segment it lies on (both copies
    # of a shared wall get it).
    e_vec = seg_b - seg_a
    e_len = np.linalg.norm(e_vec, axis=1)
    portals = [[] for _ in range(len(seg_a))]
    for (pa, pb, z_lo, z_hi) in portal_rects:
        for e in range(len(seg_a)):
            if e_len[e] < 1e-9:
                continue
            u = e_vec[e] / e_len[e]
            for p in (pa, pb):
                d = p - seg_a[e]
                s = float(d @ u)
                off = float(np.linalg.norm(d - s * u))
                if off > 0.05 or s < -0.05 or s > e_len[e] + 0.05:
                    break
            else:
                s0 = float((pa - seg_a[e]) @ u)
                s1 = float((pb - seg_a[e]) @ u)
                portals[e].append((min(s0, s1), max(s0, s1), z_lo, z_hi))

    # Dedup coincident door/opening copies (each shared W/D/O appears in
    # both rooms' lists) by canonicalized rounded endpoints.
    door_rects, seen = [], set()
    for (pa, pb, _z0, _z1) in portal_rects:
        lo, hi = sorted((tuple(np.round(pa, 3)), tuple(np.round(pb, 3))))
        if (lo, hi) in seen:
            continue
        seen.add((lo, hi))
        door_rects.append((np.asarray(pa), np.asarray(pb)))
    return FloorWorld(rooms, seg_a, seg_b, portals, door_rects=door_rects)


MAX_PORTALS_PER_SEG = 3
MAX_WALL_CANDIDATES = 16  # nearest wall crossings examined per column


def raycast_floor_world(
    world: FloorWorld,
    cam_xy: np.ndarray,
    cam_h: float,
    ceil_h: float,
    world_R: np.ndarray,
    h: int = PANO_H,
    w: int = PANO_W,
) -> Dict[str, np.ndarray]:
    """Cast pano rays through the multi-room world with transparent portals.

    Column decomposition: a pano ray's AZIMUTH — hence every wall-crossing
    distance and arc position — depends only on the pixel column, so the 2D
    wall solve is (W, E) instead of (H*W, E). Per pixel only the K nearest
    wall crossings of its column are walked (portals are axis gaps, so a
    ray traverses at most a handful of walls), and the first crossing whose
    hit height is neither above/below the wall band nor inside a portal
    rectangle blocks the ray. Floor/ceiling plane hits compete in
    horizontal-distance space; a wall that would block first wins. (No
    point-in-union test: interior portals always lead into another room;
    the rare exterior door renders a consistent world-anchored "patio".)

    Args:
        cam_xy: (2,) camera position, world-metric.
        cam_h: camera height above the floor (floor plane is z=0 world).
        ceil_h: ceiling height above the floor.
        world_R: (2,2) camera->world rotation (pano heading).

    Returns dict with camera-frame 'depth' / 'hit_xyz' (same conventions as
    raycast_layout), 'surface', and world-anchored 'wall_seg' (global
    segment index of wall hits, -1 else) + 'wall_s' (arc length, meters).
    """
    K = MAX_WALL_CANDIDATES
    rays = uni_sphere_xyz_f64(h, w).astype(np.float32)  # (h,w,3) camera frame
    a = world.seg_a.astype(np.float32)
    b = world.seg_b.astype(np.float32)
    e_vec = b - a
    e_len = np.linalg.norm(e_vec, axis=1)
    E = len(a)
    o = np.asarray(cam_xy, dtype=np.float32)
    o_z = np.float32(cam_h)

    # --- Per-column 2D solve: unit azimuth direction u[col]. -------------
    d0 = rays[0]  # any row shares the column azimuths
    u = d0[:, :2] @ np.asarray(world_R, dtype=np.float32).T
    u = u / np.maximum(np.linalg.norm(u, axis=1, keepdims=True), 1e-12)  # (W,2)

    ux, uy = u[:, 0][:, None], u[:, 1][:, None]
    denom = ux * (-e_vec[:, 1]) + uy * e_vec[:, 0]  # (W,E)
    rel = a - o
    with np.errstate(divide="ignore", invalid="ignore"):
        r2 = (rel[:, 0] * (-e_vec[:, 1]) + rel[:, 1] * e_vec[:, 0]) / denom
        s = (ux * rel[:, 1] - uy * rel[:, 0]) / denom
    hit = (np.abs(denom) > 1e-12) & (r2 > 1e-6) & (s >= 0.0) & (s <= 1.0)
    r2 = np.where(hit, r2, np.inf)  # (W,E) horizontal crossing distance

    # K nearest crossings per column, ascending.
    K_eff = min(K, E)
    part = np.argpartition(r2, K_eff - 1, axis=1)[:, :K_eff]  # (W,K)
    rk = np.take_along_axis(r2, part, axis=1)
    order = np.argsort(rk, axis=1)
    seg_k = np.take_along_axis(part, order, axis=1)  # (W,K) segment ids
    rk = np.take_along_axis(rk, order, axis=1)  # (W,K) ascending
    sk = np.take_along_axis(s, seg_k, axis=1) * e_len[seg_k]  # (W,K) arc, m
    valid_k = np.isfinite(rk)

    # Portal rectangles per segment, padded to MAX_PORTALS_PER_SEG slots.
    P = MAX_PORTALS_PER_SEG
    p_s_lo = np.full((P, E), np.inf, np.float32)
    p_s_hi = np.full((P, E), -np.inf, np.float32)
    p_z_lo = np.full((P, E), np.inf, np.float32)
    p_z_hi = np.full((P, E), -np.inf, np.float32)
    for e in range(E):
        for p, (s_lo, s_hi, z_lo, z_hi) in enumerate(world.portals[e][:P]):
            p_s_lo[p, e], p_s_hi[p, e] = s_lo - 1e-6, s_hi + 1e-6
            p_z_lo[p, e], p_z_hi[p, e] = z_lo - 1e-6, z_hi + 1e-6
    # Column-level: does candidate k's arc position fall in portal slot p?
    s_in = (sk[None] >= p_s_lo[:, seg_k]) & (sk[None] <= p_s_hi[:, seg_k])  # (P,W,K)
    zlo_k = p_z_lo[:, seg_k]  # (P,W,K)
    zhi_k = p_z_hi[:, seg_k]

    # --- Per-pixel walk of the K candidates. -----------------------------
    rho = np.maximum(np.hypot(rays[..., 0], rays[..., 1]), 1e-9)  # (h,w)
    m = rays[..., 2] / rho  # slope dz per unit horizontal distance

    z_k = o_z + rk[None, :, :] * m[..., None]  # (h,w,K)
    in_band = (z_k >= -1e-6) & (z_k <= ceil_h + 1e-6)
    in_portal = np.zeros(z_k.shape, bool)
    for p in range(P):
        in_portal |= s_in[p][None] & (z_k >= zlo_k[p][None]) & (z_k <= zhi_k[p][None])
    blocking = valid_k[None] & in_band & ~in_portal  # (h,w,K)

    first = np.argmax(blocking, axis=2)  # first True (0 if none)
    any_blk = np.take_along_axis(blocking, first[..., None], axis=2)[..., 0]
    cols = np.broadcast_to(np.arange(w), (h, w))
    r_wall = np.where(any_blk, rk[cols, first], np.inf)
    e_wall = seg_k[cols, first]
    s_wall_m = sk[cols, first]

    with np.errstate(divide="ignore", invalid="ignore"):
        r_floor = np.where(m < -1e-6, (0.0 - o_z) / m, np.inf)  # (h,w)
        r_ceil = np.where(m > 1e-6, (ceil_h - o_z) / m, np.inf)

    r_best = np.minimum(np.minimum(r_floor, r_ceil), r_wall)
    surface = np.where(
        r_best == r_wall, WALL, np.where(r_best == r_floor, FLOOR, CEILING)
    ).astype(np.int8)
    depth = np.clip(r_best / rho, 0.0, 65.0).astype(np.float32)

    hit_xyz = rays * depth[..., None]
    return {
        "depth": depth,
        "surface": surface,
        "hit_xyz": hit_xyz.astype(np.float32),
        "wall_seg": np.where(surface == WALL, e_wall.astype(np.int32), -1),
        "wall_s": np.where(surface == WALL, s_wall_m, 0.0).astype(np.float32),
    }


def render_synthetic_pano_world(
    world: FloorWorld,
    cam_xy: np.ndarray,
    cam_h: float,
    ceil_h: Optional[float] = None,
    h: int = PANO_H,
    w: int = PANO_W,
    seed: int = 0,
    world_R: Optional[np.ndarray] = None,
    door_rects=None,
) -> Dict[str, np.ndarray]:
    """Textured multi-room pano + exact depth (world-anchored textures).

    Texture formulas are IDENTICAL to render_synthetic_pano (same rng draw
    order, same world-anchored fields and hashes), so single-room and
    world renders of the same seed agree wherever both see the same
    surface point.
    """
    if ceil_h is None:
        ceil_h = 2.0 * cam_h
    if world_R is None:
        world_R = np.eye(2)
    cast = raycast_floor_world(world, cam_xy, cam_h, ceil_h, world_R, h, w)
    depth, surface = cast["depth"], cast["surface"]
    xyz = cast["hit_xyz"]

    wxy = xyz[..., :2] @ np.asarray(world_R, dtype=np.float64).T + np.asarray(
        cam_xy, dtype=np.float64
    )
    wx, wy = wxy[..., 0], wxy[..., 1]
    wz = xyz[..., 2] + cam_h

    rng = np.random.default_rng(seed)
    rgb = np.zeros((h, w, 3), dtype=np.float64)

    base_a = np.array([139, 105, 74]) + rng.integers(-15, 15, 3)
    base_b = np.array([168, 135, 100]) + rng.integers(-15, 15, 3)
    checker = ((np.floor(wx / 0.5) + np.floor(wy / 0.5)) % 2).astype(bool)
    plank = (np.floor(wy / 0.12) % 2).astype(bool)
    floor_col = np.where(checker[..., None], base_a, base_b) * np.where(
        plank[..., None], 1.0, 0.92
    )
    field = _smooth_field(wx, wy, rng)
    floor_col = floor_col * field
    floor_col = floor_col * _speckle(wx, wy, seed, 23, 0.25)[..., None]
    ix = np.floor(wx / RUG_CELL_M).astype(np.int64)
    iy = np.floor(wy / RUG_CELL_M).astype(np.int64)
    has_rug = _hash01_grid(ix, iy, seed, 11) < 0.55
    fx_in = wx - ix * RUG_CELL_M
    fy_in = wy - iy * RUG_CELL_M
    in_rug = (
        has_rug
        & (fx_in > RUG_MARGIN_M) & (fx_in < RUG_CELL_M - RUG_MARGIN_M)
        & (fy_in > RUG_MARGIN_M) & (fy_in < RUG_CELL_M - RUG_MARGIN_M)
    )
    rug_col = np.stack(
        [60.0 + 160.0 * _hash01_grid(ix, iy, seed, s) for s in (5, 6, 7)], -1
    )
    rug_stripe = (np.floor((fx_in + fy_in) / 0.2) % 2).astype(bool)
    rug_col = rug_col * np.where(rug_stripe[..., None], 1.0, 0.9)
    floor_col = np.where(in_rug[..., None], rug_col, floor_col)
    floor_col = _apply_door_mats(floor_col, wx, wy, door_rects, seed)
    rgb = np.where((surface == FLOOR)[..., None], floor_col, rgb)

    ceil_base = np.array([228, 226, 220]) + rng.integers(-8, 8, 3)
    grad = 1.0 - 0.05 * np.abs(np.sin(wx * 0.7) + np.cos(wy * 0.9)) / 2
    ceil_col = ceil_base * grad[..., None] * (1.0 + 0.6 * (field - 1.0))
    ceil_col = ceil_col * _speckle(wx, wy, seed, 29, 0.15)[..., None]
    rgb = np.where((surface == CEILING)[..., None], ceil_col, rgb)

    # Wall hue hashed from the GLOBAL segment's quantized world midpoint —
    # the same physical wall hashes identically from every viewpoint (and
    # identically to render_synthetic_pano's per-room variant).
    seg_idx = cast["wall_seg"]
    mids = 0.5 * (world.seg_a + world.seg_b)  # (E,2) world-metric
    qm = np.round(mids / 0.25).astype(np.int64)
    n_segs = max(len(world.seg_a), 1)
    hue_lut = np.array(
        [
            [
                140 + 90 * _hash01(seed, int(qm[k, 0]), int(qm[k, 1]), 1),
                140 + 90 * _hash01(seed, int(qm[k, 0]), int(qm[k, 1]), 2),
                130 + 90 * _hash01(seed, int(qm[k, 0]), int(qm[k, 1]), 3),
            ]
            for k in range(n_segs)
        ]
    )
    wall_base = hue_lut[np.clip(seg_idx, 0, n_segs - 1)]
    stripe = (np.floor((wx + wy) / 0.25) % 2).astype(bool)
    baseboard = wz < 0.12
    crown = wz > (ceil_h - 0.10)
    wall_col = wall_base * np.where(stripe[..., None], 1.0, 0.90)
    wall_col = np.where(baseboard[..., None], np.array([70.0, 60, 55]), wall_col)
    wall_col = np.where(crown[..., None], np.array([210.0, 208, 200]), wall_col)
    rgb = np.where((surface == WALL)[..., None], wall_col, rgb)

    shade = 1.0 / (1.0 + 0.035 * depth)
    rgb = rgb * shade[..., None]
    rgb = rgb + rng.normal(0.0, 2.5, rgb.shape)
    out = dict(cast)
    out["rgb"] = np.clip(rgb, 0, 255).astype(np.uint8)
    return out


def synthetic_pano_for_pano_data(
    pano,
    camera_height_m: float,
    seed: Optional[int] = None,
    scale_meters_per_coordinate: Optional[float] = None,
):
    """Convenience: synthetic pano for a PanoData (ego-normalized layout).

    ZInD layouts are ego-normalized (camera height == 1 unit,
    salve/common/pano_data.py parse asserts camera_height == 1.0), so metric
    vertices are layout * camera_height_m.

    When scale_meters_per_coordinate is given, textures are anchored in the
    building's world-metric frame (derived from pano.global_Sim2_local):
    p_world_m = R @ p_cam_m + camera_height_m * t, since the pano scale
    satisfies S * s_pano = camera_height_m. Pass the same `seed` for every
    pano of a building so they share one texture world.

    The pano's camera (sphere) frame follows the real-ZInD convention:
    ego = R_FIX @ sphere (see R_FIX above), so the production backprojection
    chain recovers the parsed ego frame exactly.
    """
    verts_ego = np.asarray(pano.room_vertices_local_2d, dtype=np.float64)
    # Camera-frame verts: R_render^T (w - c) = R_FIX^T @ ego (row form: @ R_FIX).
    verts_m = (verts_ego @ R_FIX) * float(camera_height_m)
    world_R = world_t = None
    if scale_meters_per_coordinate is not None:
        world_R = (
            np.asarray(pano.global_Sim2_local.rotation, dtype=np.float64) @ R_FIX
        )
        world_t = camera_height_m * np.asarray(
            pano.global_Sim2_local.translation, dtype=np.float64
        )
    return render_synthetic_pano(
        verts_m,
        camera_height_m=camera_height_m,
        seed=int(pano.id) if seed is None else seed,
        world_R=world_R,
        world_t=world_t,
    )
