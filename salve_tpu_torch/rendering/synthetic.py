"""Synthetic equirect panos ray-cast from room layouts: the numpy copy of
what the depth slice needs from salve_tpu/rendering/synthetic.py.

`raycast_layout` casts every pano ray against a vertical-prism room (floor
polygon, camera and ceiling heights) and returns exact metric depth along
each ray; `render_synthetic_pano` textures the same cast into an RGB pano.
Together they supervise and measure the depth net without real imagery
(`training/depth.py`, `models/depth_net.py:synthesize_depth_from_layout`).

The copy is numpy float64, as the original is. Its ray grid is
`uni_sphere_xyz_f64`, a float64 numpy grid equal to
salve_tpu/geometry/pano_projection.py:157, and not the port's
`geometry/pano_projection.py:get_uni_sphere_xyz` (a float32 torch grid on
glibc's sinf/cosf for the backprojection): with it the casts equal the
original's bit for bit.

The multi-room floor-world functions of the original (`build_floor_world`
onward) are not copied here.
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
