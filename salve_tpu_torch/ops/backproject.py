"""Equirectangular depth-map backprojection to coloured point clouds.

Port of salve_tpu/ops/backproject.py, written batched over panos instead of
through `vmap`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from salve_tpu_torch.geometry.pano_projection import get_uni_sphere_xyz

# The reference crops 80/512 rows from pano top and bottom (noisy depth).
DEFAULT_CROP_RATIO = 80.0 / 512.0
# Depth PNGs store millimeters as uint16.
DEPTH_SCALE = 0.001

# z-range crops per rendered surface: floor keeps >= 1 m below the camera,
# ceiling >= 0.5 m above.
FLOOR_Z_RANGE = (-float("inf"), -1.0)
CEILING_Z_RANGE = (0.5, float("inf"))


def surface_row_window(H: int, z_range: Tuple[float, float], crop_ratio: float) -> Tuple[int, int]:
    """Pano-row window that can hold points with z in `z_range`.

    Rows above the horizon have strictly positive ray z, rows below strictly
    negative, so a floor surface comes only from the lower half and a
    ceiling from the upper half; intersected with the noise crop.
    """
    crop = int(H * crop_ratio)
    r0, r1 = crop, H - crop
    zmin, zmax = z_range
    if zmax <= 0:
        r0 = max(r0, H // 2)
    if zmin >= 0:
        r1 = min(r1, H // 2)
    return r0, r1


def backproject_depth(
    depth_mm: torch.Tensor,
    rgb: torch.Tensor,
    z_range: Tuple[float, float],
    crop_ratio: float = DEFAULT_CROP_RATIO,
    row_window: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backproject (B, H, W) depth maps into coloured clouds.

    Args:
        depth_mm: (B, H, W) depth in millimeters (any real or integer dtype).
        rgb: (B, H, W, 3) float RGB in [0, 1].
        z_range: (zmin, zmax]; points outside are marked invalid.
        row_window: (r0, r1) row slice replacing the crop (surface_row_window);
            rays keep their full-pano v angles.

    Returns:
        xyz (B, N, 3) float32, rgb (B, N, 3) float32, valid (B, N) bool,
        with N = (r1 - r0) * W.
    """
    b, H, W = depth_mm.shape
    if row_window is None:
        crop = int(H * crop_ratio)
        row_window = (crop, H - crop)
    r0, r1 = row_window

    depth_m = depth_mm[:, r0:r1].to(torch.float32) * DEPTH_SCALE
    rays = get_uni_sphere_xyz(H, W, device=depth_mm.device)[r0:r1]
    xyz = depth_m[..., None] * rays[None]
    xyz = xyz.reshape(b, -1, 3)
    colors = rgb[:, r0:r1].reshape(b, -1, 3).to(torch.float32)

    z = xyz[..., 2]
    valid = (z > z_range[0]) & (z <= z_range[1])
    return xyz, colors, valid


def resize_pano_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(H, W, C) -> (out_h, out_w, C) float32 bilinear resize.

    Matches jax.image.resize(method="linear"), which antialiases when it
    downsamples; hence `antialias=True`.
    """
    x = img.to(torch.float32).permute(2, 0, 1)[None]
    x = F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=False, antialias=True)
    return x[0].permute(1, 2, 0)
