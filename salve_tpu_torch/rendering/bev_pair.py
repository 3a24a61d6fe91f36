"""BEV texture-map renders of panos in their own or a partner's frame.

Port of the fused-scoring half of salve_tpu/rendering/bev_pair.py:
`render_identity_batched`, `render_transformed_batched`, the render config,
and the host-side IO helpers, which read images with the port's own JPEG and
PNG readers (native/), not imageio.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple, Tuple

import numpy as np
import torch

from salve_tpu_torch.native import jpeg, png
from salve_tpu_torch.ops import backproject as bp
from salve_tpu_torch.ops import bev as bev_ops

# HoHoNet's pano center faces -x, ZInD's +y: a -90 deg rotation fixes it
# (bev_rendering_utils.py:443). HoHoNet metric scale vs ZInD world-normalized
# scale differs by 1.5 (bev_rendering_utils.py:448).
HOHO_S_ZIND_SCALE_FACTOR = 1.5
_R_FIX = np.array([[0.0, 1.0], [-1.0, 0.0]], dtype=np.float32)  # rotmat2d(-90)

PANO_H, PANO_W = 512, 1024


class BEVRenderConfig(NamedTuple):
    """Rendering hyperparameters (salve_tpu/rendering/bev_pair.py:34)."""

    img_px: int = bev_ops.DEFAULT_BEV_IMG_PX
    meters_per_px: float = bev_ops.DEFAULT_METERS_PER_PX
    crop_ratio: float = bp.DEFAULT_CROP_RATIO
    is_semantics: bool = False


def surface_clouds(
    depths: torch.Tensor, rgbs: torch.Tensor, z_range: Tuple[float, float], cfg: BEVRenderConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backproject (B, H, W) panos of one surface and apply the frame fix.

    xy @ _R_FIX.T is (y, -x), written out: exact, whatever the matmul
    precision.
    """
    if cfg.is_semantics:
        raise NotImplementedError("semantic renders are not ported yet")
    window = bp.surface_row_window(depths.shape[1], z_range, cfg.crop_ratio)
    xyz, c, v = bp.backproject_depth(depths, rgbs, z_range, cfg.crop_ratio, window)
    xyz = torch.stack([xyz[..., 1], -xyz[..., 0], xyz[..., 2]], dim=-1)
    return xyz, c, v


def render_identity_batched(
    depths: torch.Tensor, rgbs: torch.Tensor, z_range: Tuple[float, float], cfg: BEVRenderConfig
) -> torch.Tensor:
    """Render (B, H, W) panos in their own frames -> (B, h, w, 3) uint8."""
    xyz, c, v = surface_clouds(depths, rgbs, z_range, cfg)
    return bev_ops.render_bev_images_batched(xyz, c, v, cfg.img_px, cfg.meters_per_px)


def render_transformed_batched(
    depths: torch.Tensor,
    rgbs: torch.Tensor,
    i2Ri1: torch.Tensor,
    i2ti1: torch.Tensor,
    z_range: Tuple[float, float],
    cfg: BEVRenderConfig,
) -> torch.Tensor:
    """Render (B, H, W) panos moved into the partner frame -> (B, h, w, 3) uint8.

    Pano 1's cloud goes through the hypothesis (R, t * 1.5) before the splat.
    """
    xyz, c, v = surface_clouds(depths, rgbs, z_range, cfg)
    x, y = xyz[..., 0], xyz[..., 1]
    R = i2Ri1.to(torch.float32)[:, None]
    t = (i2ti1.to(torch.float32) * HOHO_S_ZIND_SCALE_FACTOR)[:, None]
    xt = R[..., 0, 0] * x + R[..., 0, 1] * y + t[..., 0]
    yt = R[..., 1, 0] * x + R[..., 1, 1] * y + t[..., 1]
    xyz = torch.stack([xt, yt, xyz[..., 2]], dim=-1)
    return bev_ops.render_bev_images_batched(xyz, c, v, cfg.img_px, cfg.meters_per_px)


# ---------------------------------------------------------------------------
# Host-side IO helpers (filename grammar parity with the reference).
# ---------------------------------------------------------------------------


def bev_fname_from_img_fpath(
    pair_idx: int, pair_uuid: str, surface_type: str, img_fpath: str, modality: str = "rgb"
) -> str:
    """BEV texture-map filename; Stage C/D parse this grammar back."""
    fname_stem = Path(img_fpath).stem
    return f"pair_{pair_idx}___{pair_uuid}_{surface_type}_{modality}_{fname_stem}.jpg"


def read_image(img_fpath: str) -> np.ndarray:
    """A JPEG or PNG file's pixels as `imageio.v2.imread` returns them, read
    by the port's own readers (native/): by the file's signature, not its
    name."""
    data = Path(img_fpath).read_bytes()
    if data[:3] == b"\xff\xd8\xff":
        return jpeg.decode_jpeg_bytes(data)
    if data[:8] == png.SIGNATURE:
        return png.decode_png_bytes(data)
    raise ValueError(f"{img_fpath}: neither a JPEG nor a PNG file")


def load_pano_rgb(img_fpath: str) -> np.ndarray:
    """Load a pano JPG, bilinearly resized to (512, 1024), in [0, 1]."""
    rgb = read_image(img_fpath)
    if rgb.ndim == 2:
        rgb = np.stack([rgb] * 3, axis=-1)
    rgb = bp.resize_pano_bilinear(torch.from_numpy(np.asarray(rgb)), PANO_H, PANO_W).numpy()
    return rgb / 255.0


def load_depth_mm(depth_fpath: str) -> np.ndarray:
    """Load a cached u16 depth PNG (millimeters), shape (512, 1024)."""
    return png.read_png(depth_fpath)
