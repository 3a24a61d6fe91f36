"""Plain BEV texture renders and Sim(2) warps of a floor's panos.

Written from SALVe's rendering (salve/utils/bev_rendering_utils.py): every
pano pixel is backprojected along its ray with its depth, points of one
surface (floor: z <= -1 m, ceiling: z > 0.5 m) are splatted top-down on a
grid at 0.02 m/px with the highest z-slice (then the last point) winning a
cell, holes are filled by six rounds of 3x3 averaging, cells with no
support in their 11x11 window and cells outside the convex hull of the
occupied cells are blanked, and the image is flipped vertically.

A hypothesis render of pano 1 in pano 2's frame is a nearest-neighbour
Sim(2) resample of pano 1's render on a grid of twice the extent (the
configuration's warp mode). On the card the program resamples with the
3-shear factorisation (each pass rounded to the nearest cell), on the CPU
with the exact gather; `warp` follows the same rule, so both sides read
the same cells.

Departures from the program's arithmetic, none of which the program's
result may depend on beyond a cell at a rounding tie: the ray grid uses
torch's float32 sin and cos, divisions are IEEE divisions.

Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

FLOOR_Z = (-float("inf"), -1.0)
CEILING_Z = (0.5, float("inf"))
CROP_RATIO = 80.0 / 512.0
ZMIN, ZMAX, Z_SLICES = -2.0, 2.0, 4
FILL_ITERS = 6
MASK_K = 11
HULL_DIRECTIONS = 64
HOHONET_TO_ZIND_SCALE = 1.5
IMAGENET_MEAN = (0.485 * 255, 0.456 * 255, 0.406 * 255)
IMAGENET_STD = (0.229 * 255, 0.224 * 255, 0.225 * 255)


def surface_cloud(depth_mm: torch.Tensor, rgb: torch.Tensor, z_range) -> Tuple[torch.Tensor, ...]:
    """(P, H, W) depth in mm and (P, H, W, 3) rgb in [0, 1] -> xyz (P, N, 3)
    in the ZInD frame, rgb (P, N, 3), valid (P, N), for the pano rows that
    can hold the surface (the noise crop of 80/512 rows at top and bottom,
    the lower half for the floor, the upper for the ceiling)."""
    _, h, w = depth_mm.shape
    crop = int(h * CROP_RATIO)
    r0, r1 = crop, h - crop
    if z_range[1] <= 0:
        r0 = max(r0, h // 2)
    if z_range[0] >= 0:
        r1 = min(r1, h // 2)
    dev = depth_mm.device
    u = -(torch.arange(w, device=dev, dtype=torch.float32) + 0.5) / w * 2 * math.pi
    v = ((torch.arange(h, device=dev, dtype=torch.float32) + 0.5) / h - 0.5) * math.pi
    rays = torch.stack([torch.cos(v)[:, None] * torch.cos(u)[None, :],
                        torch.cos(v)[:, None] * torch.sin(u)[None, :],
                        (-torch.sin(v))[:, None].expand(h, w)], dim=-1)[r0:r1]
    xyz = (depth_mm[:, r0:r1].to(torch.float32) * 0.001)[..., None] * rays[None]
    xyz = xyz.reshape(depth_mm.shape[0], -1, 3)
    z = xyz[..., 2]
    valid = (z > z_range[0]) & (z <= z_range[1])
    # HoHoNet's pano faces -x, ZInD's +y: rotate by -90 degrees.
    xyz = torch.stack([xyz[..., 1], -xyz[..., 0], z], dim=-1)
    return xyz, rgb[:, r0:r1].reshape(depth_mm.shape[0], -1, 3).to(torch.float32), valid


def _box_sum(x: torch.Tensor, k: int) -> torch.Tensor:
    r = k // 2
    rows = x.clone()
    for d in range(1, r + 1):
        rows[..., d:, :] += x[..., :-d, :]
        rows[..., :-d, :] += x[..., d:, :]
    out = rows.clone()
    for d in range(1, r + 1):
        out[..., :, d:] += rows[..., :, :-d]
        out[..., :, :-d] += rows[..., :, d:]
    return out


def _hull_mask(occ: torch.Tensor) -> torch.Tensor:
    """(B, H, W): inside the outer 64-gon around the occupied cells."""
    _, h, w = occ.shape
    dev = occ.device
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    big = 1e9
    xmin = torch.where(occ, xs, torch.tensor(big, device=dev)).amin(dim=2)
    xmax = torch.where(occ, xs, torch.tensor(-big, device=dev)).amax(dim=2)
    row_has = occ.any(dim=2)
    theta = torch.arange(HULL_DIRECTIONS, dtype=torch.float32, device=dev) * (2 * math.pi / HULL_DIRECTIONS)
    cos, sin = torch.cos(theta), torch.sin(theta)
    proj = torch.stack([xmin, xmax], -1)[..., None] * cos + ys[None, :, None, None] * sin
    hsup = torch.where(row_has[..., None, None], proj, torch.tensor(-big, device=dev)).amax(dim=(1, 2))
    t = hsup[:, None, :] - ys[None, :, None] * sin
    eps = 1e-4
    pos, neg = cos > eps, cos < -eps
    one = torch.ones_like(cos)
    xhi = torch.where(pos, t / torch.where(pos, cos, one), torch.tensor(big, device=dev)).amin(-1)
    xlo = torch.where(neg, t / torch.where(neg, cos, one), torch.tensor(-big, device=dev)).amax(-1)
    row_ok = torch.where(cos.abs() <= eps, t >= -eps, torch.ones_like(t, dtype=torch.bool)).all(-1)
    return row_ok[..., None] & (xs >= xlo[..., None] - 1e-3) & (xs <= xhi[..., None] + 1e-3)


def render(xyz: torch.Tensor, rgb: torch.Tensor, valid: torch.Tensor, img_px: int, mpp: float) -> torch.Tensor:
    """(B, N) clouds -> (B, img_px+1, img_px+1, 3) uint8 texture maps."""
    b, n, _ = xyz.shape
    side = img_px + 1
    half_m = int((img_px / 2) * mpp)
    xy = xyz[..., :2]
    inside = ((xy >= -half_m) & (xy <= half_m)).all(-1)
    q = torch.round((xy + half_m) / mpp).to(torch.int64)
    z = xyz[..., 2]
    ok = valid & inside & (q >= 0).all(-1) & (q < side).all(-1) & (z >= ZMIN) & (z < ZMAX)
    z_bin = torch.floor((z - ZMIN) / (ZMAX - ZMIN) * Z_SLICES).to(torch.int64)
    key = torch.where(ok, z_bin * n + torch.arange(n, device=xyz.device), -1)
    cell = torch.where(ok, q[..., 1] * side + q[..., 0], side * side)
    grid = torch.full((b, side * side + 1), -1, dtype=torch.int64, device=xyz.device)
    grid.scatter_reduce_(1, cell, key, reduce="amax")
    grid = grid[:, :-1]
    occ = grid >= 0
    win = torch.gather(torch.clamp(torch.round(rgb * 255.0), 0, 255), 1,
                       torch.where(occ, grid % n, 0)[..., None].expand(b, -1, 3))
    sparse = torch.where(occ[..., None], win, 0.0).view(b, side, side, 3)
    occ = occ.view(b, side, side)
    support = (sparse > 0).all(-1)

    img = sparse.permute(0, 3, 1, 2).contiguous()
    o = occ[:, None].to(torch.float32)
    for _ in range(FILL_ITERS):
        den = _box_sum(o, 3)
        fill = _box_sum(img * o, 3) / torch.clamp(den, min=1.0)
        img = torch.where(o > 0, img, fill)
        o = torch.maximum(o, den.clamp(0.0, 1.0))
    img = img.permute(0, 2, 3, 1)
    keep = (_box_sum(support.to(torch.float32), MASK_K) > 0.5) & _hull_mask(occ)
    out = torch.where(keep[..., None], img, 0.0)
    return torch.flip(torch.clamp(torch.round(out), 0, 255).to(torch.uint8), dims=[1])


def render_banks(depth_mm, rgb, img_px: int, mpp: float, bank_px: int):
    """(identity ceiling, identity floor, extended ceiling, extended floor)
    renders of every pano, uint8."""
    out = []
    for z_range in (CEILING_Z, FLOOR_Z):
        xyz, c, v = surface_cloud(depth_mm, rgb, z_range)
        out.append((render(xyz, c, v, img_px, mpp), render(xyz, c, v, bank_px, mpp)))
    return out[0][0], out[1][0], out[0][1], out[1][1]


# --- warps --------------------------------------------------------------

_TAN22 = math.tan(math.pi / 8)
_SIN45 = math.sin(math.pi / 4)


def warp_gather(bank: torch.Tensor, R: torch.Tensor, t: torch.Tensor, img_px: int, mpp: float) -> torch.Tensor:
    """Exact nearest-neighbour Sim(2) resample: (B, S, S, 3) u8 banks (one
    per hypothesis), R (B, 2, 2), t (B, 2) in target metres -> (B, d, d, 3)."""
    b, s = bank.shape[:2]
    d = img_px + 1
    dev = bank.device
    half_dst = int((img_px / 2) * mpp)
    half_src = int(((s - 1) / 2) * mpp)
    px = torch.arange(d, dtype=torch.float32, device=dev)
    wx = (px * mpp - half_dst)[None, :].expand(d, d)
    wy = ((d - 1 - px) * mpp - half_dst)[:, None].expand(d, d)
    rx, ry = wx[None] - t[:, 0, None, None], wy[None] - t[:, 1, None, None]
    sx = R[:, 0, 0, None, None] * rx + R[:, 1, 0, None, None] * ry
    sy = R[:, 0, 1, None, None] * rx + R[:, 1, 1, None, None] * ry
    qx = torch.round((sx + half_src) / mpp).long()
    qy = torch.round((sy + half_src) / mpp).long()
    inb = (qx >= 0) & (qx < s) & (qy >= 0) & (qy < s)
    flat = torch.where(inb, (s - 1 - qy) * s + qx, 0)
    got = torch.gather(bank.reshape(b, s * s, 3), 1, flat.reshape(b, -1, 1).expand(-1, -1, 3)).view(b, d, d, 3)
    return torch.where(inb[..., None], got, 0)


def _row_slice(img: torch.Tensor, starts: torch.Tensor, span: int) -> torch.Tensor:
    w = img.shape[2]
    cols = starts[..., None] + torch.arange(span, device=img.device)
    got = torch.gather(img, 2, cols.clamp(0, w - 1)[..., None].expand(-1, -1, -1, img.shape[3]))
    return torch.where(((cols >= 0) & (cols < w))[..., None], got, 0)


def warp_shear(bank: torch.Tensor, R: torch.Tensor, t: torch.Tensor, img_px: int, mpp: float) -> torch.Tensor:
    """Nearest-neighbour Sim(2) resample by three shears (Paeth, 1986): the
    map target -> source pixel is reduced to rot(phi) . rot90^n with phi in
    [-45, 45] degrees and rot(phi) = shear_x(a) shear_y(s) shear_x(a),
    a = -tan(phi / 2), s = sin(phi); each pass moves whole rows by a
    rounded offset. Same contract as `warp_gather`."""
    b, s = bank.shape[:2]
    dev = bank.device
    d = img_px + 1
    half_dst = int((img_px / 2) * mpp)
    half_src = int(((s - 1) / 2) * mpp)
    A = R.transpose(1, 2)
    tx, ty = t[:, 0], t[:, 1]
    b0 = (half_src - (A[:, 0, 0] * (half_dst + tx) + A[:, 0, 1] * (half_dst + ty))) / mpp
    b1 = (half_src - (A[:, 1, 0] * (half_dst + tx) + A[:, 1, 1] * (half_dst + ty))) / mpp
    psi = torch.atan2(A[:, 1, 0], A[:, 0, 0])
    k = torch.round(psi / (math.pi / 2))
    n = k.long() % 4
    phi = psi - k * (math.pi / 2)
    a, sn = -torch.tan(phi / 2), torch.sin(phi)
    c = (d - 1) / 2.0
    qc0 = torch.where((n == 1) | (n == 2), -2.0 * c, 0.0)
    qc1 = torch.where((n == 2) | (n == 3), -2.0 * c, 0.0)
    b0 = b0 + torch.cos(phi) * qc0 - torch.sin(phi) * qc1
    b1 = b1 + torch.sin(phi) * qc0 + torch.cos(phi) * qc1

    x3 = d + int(math.ceil(_TAN22 * (d - 1)))
    y2 = d + int(math.ceil(_SIN45 * (x3 - 1)))
    o3 = torch.clamp(torch.round(a * (d - 1)), max=0.0)
    r2 = torch.round(sn[:, None] * (torch.arange(x3, device=dev, dtype=torch.float32)[None] + o3[:, None]))
    o2 = torch.clamp(r2.amin(dim=1), max=0.0)
    y2_log = torch.arange(y2, device=dev, dtype=torch.float32)[None] + o2[:, None]
    row0 = (y2_log[:, 0] + torch.round(b1)).long()
    starts1 = (o3[:, None] + torch.round(a[:, None] * y2_log + b0[:, None])).long()
    starts2 = (r2 - o2[:, None]).long()
    starts3 = (torch.round(a[:, None] * torch.arange(d, device=dev, dtype=torch.float32)[None])
               - o3[:, None]).long()

    src = torch.flip(bank, dims=[1])  # stored rows -> pre-flip rows
    rows = row0[:, None] + torch.arange(y2, device=dev)
    pass0 = torch.gather(src, 1, rows.clamp(0, s - 1)[..., None, None].expand(-1, -1, s, src.shape[3]))
    pass0 = torch.where(((rows >= 0) & (rows < s))[..., None, None], pass0, 0)
    p1 = _row_slice(pass0, starts1, x3)  # (B, y2, x3, C)
    p2 = _row_slice(p1.transpose(1, 2), starts2, d).transpose(1, 2)  # (B, d, x3, C)
    p3 = _row_slice(p2, starts3, d)  # (B, d, d, C)
    variants = torch.stack([p3, torch.flip(p3, dims=[2]).transpose(1, 2), torch.flip(p3, dims=[1, 2]),
                            torch.flip(p3, dims=[1]).transpose(1, 2)], dim=1)
    out = variants[torch.arange(b, device=dev), n]
    return torch.flip(out, dims=[1])


def warp(bank, R, t, img_px, mpp):
    """The configuration's warp on the bank's device (module docstring)."""
    fn = warp_shear if bank.device.type == "cuda" else warp_gather
    return fn(bank, R, t, img_px, mpp)


def verifier_input(ceil1, ceil2, floor1, floor2, resize_px: int, crop_px: int) -> list:
    """Four (B, d, d, 3) u8 renders -> four (B, 3, crop, crop) float32
    images: bilinear resize (antialiased), centre crop, ImageNet
    normalisation."""
    x = torch.stack([ceil1, ceil2, floor1, floor2], dim=1)
    b, n, h, w, _ = x.shape
    x = x.reshape(b * n, h, w, 3).permute(0, 3, 1, 2).to(torch.float32)
    x = F.interpolate(x, size=(resize_px, resize_px), mode="bilinear", align_corners=False, antialias=True)
    off = (resize_px - crop_px) // 2
    x = x[:, :, off:off + crop_px, off:off + crop_px]
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, device=x.device)[:, None, None]
    x = ((x - mean) / std).reshape(b, n, 3, crop_px, crop_px)
    return [x[:, i] for i in range(n)]
