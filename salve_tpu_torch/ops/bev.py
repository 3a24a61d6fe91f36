"""BEV texture-map rendering: bbox prune -> z-order splat -> fill -> mask.

Port of salve_tpu/ops/bev.py:render_bev_images_batched (the texture branch,
bev.py:404-431) and convex_hull_mask. The splat is kernel B1
(ops/splat.py) and the fill + hallucination mask kernel B2 (ops/fill.py).
Semantic renders (`is_semantics=True`, nearest_fill) are not ported yet.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from salve_tpu_torch.ops.fill import fill_and_mask
from salve_tpu_torch.ops.numerics import div_const
from salve_tpu_torch.ops.splat import splat_zorder_batched

# Grid defaults (salve_tpu/ops/bev.py:39-40): 501x501 renders at 0.02 m/px.
DEFAULT_BEV_IMG_PX = 500
DEFAULT_METERS_PER_PX = 0.02


def convex_hull_mask(occupied: torch.Tensor, n_directions: int = 64) -> torch.Tensor:
    """(..., H, W) bool: pixels inside the convex hull of occupied cells.

    Outer D-gon approximation from per-row support extremes
    (salve_tpu/ops/bev.py:266).
    """
    batch = occupied.shape[:-2]
    h, w = occupied.shape[-2:]
    dev = occupied.device
    occ = occupied.reshape(-1, h, w)
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    big = torch.tensor(1e9, dtype=torch.float32, device=dev)
    xmin = torch.where(occ, xs[None, None, :], big).amin(dim=2)  # (B, H)
    xmax = torch.where(occ, xs[None, None, :], -big).amax(dim=2)
    row_has = occ.any(dim=2)

    theta = torch.arange(n_directions, dtype=torch.float32, device=dev) * (
        2.0 * math.pi / n_directions
    )
    cos, sin = torch.cos(theta), torch.sin(theta)

    ext_x = torch.stack([xmin, xmax], dim=-1)  # (B, H, 2)
    proj = ext_x[..., None] * cos + ys[None, :, None, None] * sin  # (B, H, 2, D)
    proj = torch.where(row_has[..., None, None], proj, -big)
    hsup = proj.amax(dim=(1, 2))  # (B, D)

    t = hsup[:, None, :] - ys[None, :, None] * sin  # (B, H, D)
    eps = 1e-4
    pos = cos > eps
    neg = cos < -eps
    one = torch.ones_like(cos)
    xhi = torch.where(pos, t / torch.where(pos, cos, one), big).amin(dim=-1)
    xlo = torch.where(neg, t / torch.where(neg, cos, one), -big).amax(dim=-1)
    row_ok = torch.where(cos.abs() <= eps, t >= -eps, torch.ones_like(t, dtype=torch.bool)).all(dim=-1)
    tol = 1e-3
    mask = (
        row_ok[..., None]
        & (xs[None, None, :] >= xlo[..., None] - tol)
        & (xs[None, None, :] <= xhi[..., None] + tol)
    )
    return mask.reshape(batch + (h, w))


def splat_inputs(
    xyz: torch.Tensor,
    rgb: torch.Tensor,
    valid: torch.Tensor,
    img_px: int = DEFAULT_BEV_IMG_PX,
    meters_per_px: float = DEFAULT_METERS_PER_PX,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(xy_img, z, rgb255, valid) of world clouds on an (img_px+1)^2 grid.

    bbox prune, then p_img = round((p_world + half) / meters_per_px), half to
    even (salve_tpu/ops/bev.py:372-388).
    """
    half_m = int((img_px / 2) * meters_per_px)
    xy = xyz[..., :2]
    inside = (
        (xy[..., 0] >= -half_m)
        & (xy[..., 0] <= half_m)
        & (xy[..., 1] >= -half_m)
        & (xy[..., 1] <= half_m)
    )
    xy_img = torch.round(div_const(xy + half_m, meters_per_px)).to(torch.int32)
    return xy_img, xyz[..., 2], rgb * 255.0, valid & inside


def render_bev_images_batched(
    xyz: torch.Tensor,
    rgb: torch.Tensor,
    valid: torch.Tensor,
    img_px: int = DEFAULT_BEV_IMG_PX,
    meters_per_px: float = DEFAULT_METERS_PER_PX,
) -> torch.Tensor:
    """Batched BEV texture render: (B, N) clouds -> (B, H, W, 3) uint8.

    bbox prune -> world->image rounding -> z-order splat (packed rgb888
    winners) -> fill + hallucination mask -> convex hull -> vertical flip.
    """
    img_h = img_w = img_px + 1
    xy_img, z, rgb255, valid = splat_inputs(xyz, rgb, valid, img_px, meters_per_px)
    sparse, occupied = splat_zorder_batched(
        xy_img, z, rgb255, valid, img_h, img_w, quantize_u8=True
    )
    sparse_u8 = torch.clamp(torch.round(sparse), 0, 255).to(torch.uint8)
    support = (sparse_u8 > 0).all(dim=-1)

    hull = convex_hull_mask(occupied)
    out = fill_and_mask(sparse.contiguous(), occupied.contiguous(), support.contiguous())
    out = torch.where(hull[..., None], out, torch.zeros_like(out))
    out = torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    return torch.flip(out, dims=[1])  # flipud, as in the reference
