"""BEV texture-map rendering: bbox prune -> z-order splat -> fill -> mask.

Port of salve_tpu/ops/bev.py: render_bev_images_batched (both branches) and
its single-cloud form `render_bev_image`, convex_hull_mask, the world->image
Sim(2) of a render, and the plain-torch fills and masks. The splat is kernel
B1 (ops/splat.py); the texture branch's fill + hallucination mask is kernel
B2 (ops/fill.py). The semantic branch (`is_semantics=True`) fills with
`nearest_fill` and masks with `hallucination_mask`, plain torch on the
render's device, as salve_tpu takes XLA there and not its Pallas fill.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

# fill_holes (salve_tpu/ops/bev.py:210) lives beside B2's plain version, whose loop it is.
from salve_tpu_torch.ops.fill import (  # noqa: F401
    DEFAULT_MASK_KERNEL, FILL_ITERS, fill_and_mask, fill_holes, support_mask,
)
from salve_tpu_torch.ops.numerics import div_const
from salve_tpu_torch.ops.splat import splat_zorder_batched

# Grid defaults (salve_tpu/ops/bev.py:39-40): 501x501 renders at 0.02 m/px.
DEFAULT_BEV_IMG_PX = 500
DEFAULT_METERS_PER_PX = 0.02


def splat_zorder(
    xy_img: torch.Tensor, z: torch.Tensor, rgb: torch.Tensor, valid: torch.Tensor, img_h: int, img_w: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-cloud z-order splat ((N, ...) -> (H, W, ...)); see the batched form."""
    sparse, occupied = splat_zorder_batched(xy_img[None], z[None], rgb[None], valid[None], img_h, img_w)
    return sparse[0], occupied[0]


def nearest_fill(sparse_img: torch.Tensor, occupied: torch.Tensor, iters: int = FILL_ITERS) -> torch.Tensor:
    """Fill for semantic maps (salve_tpu/ops/bev.py:235): each round an empty
    cell takes the exact colour of its first occupied neighbour in the order
    (dy, dx) = (-1, -1), (-1, 0), ..., (1, 1), rolled with wraparound, never
    blending palette colours. (..., H, W, 3) with (..., H, W) occupancy."""
    img, occ = sparse_img, occupied
    for _ in range(iters):
        best, best_occ = img, occ
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dx == 0 and dy == 0:
                    continue
                sh_img = torch.roll(img, shifts=(dy, dx), dims=(-3, -2))
                sh_occ = torch.roll(occ, shifts=(dy, dx), dims=(-2, -1))
                take = ~best_occ & sh_occ
                best = torch.where(take[..., None], sh_img, best)
                best_occ = best_occ | sh_occ
        img, occ = best, best_occ
    return img


def hallucination_mask(sparse_img_u8: torch.Tensor, k: int = DEFAULT_MASK_KERNEL) -> torch.Tensor:
    """(..., H, W) bool: cells with >= 1 support in their k x k window, where
    support is all three channels nonzero (salve_tpu/ops/bev.py:324)."""
    return support_mask((sparse_img_u8 > 0).all(dim=-1), k)


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
    big = 1e9  # a Python scalar: no copy to the card, which would wait for its stream
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
    is_semantics: bool = False,
) -> torch.Tensor:
    """Batched BEV render: (B, N) clouds -> (B, H, W, 3) uint8.

    bbox prune -> world->image rounding -> z-order splat (packed rgb888
    winners) -> fill + hallucination mask -> vertical flip. Textures fill
    with B2 inside the occupied cells' convex hull; semantic maps take
    `nearest_fill` over the whole grid (no hull), as salve_tpu does.
    """
    img_h = img_w = img_px + 1
    xy_img, z, rgb255, valid = splat_inputs(xyz, rgb, valid, img_px, meters_per_px)
    sparse, occupied = splat_zorder_batched(
        xy_img, z, rgb255, valid, img_h, img_w, quantize_u8=True
    )
    sparse_u8 = torch.clamp(torch.round(sparse), 0, 255).to(torch.uint8)

    if is_semantics:
        out = torch.where(hallucination_mask(sparse_u8)[..., None], nearest_fill(sparse, occupied), 0.0)
    else:
        support = (sparse_u8 > 0).all(dim=-1)
        hull = convex_hull_mask(occupied)
        out = fill_and_mask(sparse.contiguous(), occupied.contiguous(), support.contiguous())
        out = torch.where(hull[..., None], out, torch.zeros_like(out))
    out = torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    return torch.flip(out, dims=[1])  # flipud, as in the reference


def render_bev_image(
    xyz: torch.Tensor,
    rgb: torch.Tensor,
    valid: torch.Tensor,
    img_px: int = DEFAULT_BEV_IMG_PX,
    meters_per_px: float = DEFAULT_METERS_PER_PX,
    is_semantics: bool = False,
) -> torch.Tensor:
    """Single-cloud render ((N, ...) -> (H, W, 3) uint8): the batched form at
    B = 1, so a texture launches B1 and B2 once each."""
    return render_bev_images_batched(xyz[None], rgb[None], valid[None], img_px, meters_per_px, is_semantics)[0]


def make_bevimg_Sim2_world(
    img_px: int = DEFAULT_BEV_IMG_PX, meters_per_px: float = DEFAULT_METERS_PER_PX
) -> Tuple[np.ndarray, np.ndarray, float]:
    """(R, t, s) of the world->image Sim(2) (salve_tpu/ops/bev.py:448)."""
    half_m = int((img_px / 2) * meters_per_px)
    return np.eye(2), np.array([half_m, half_m], dtype=np.float64), 1.0 / meters_per_px
