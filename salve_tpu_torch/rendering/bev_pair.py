"""BEV texture-map renders of panos in their own or a partner's frame.

Port of salve_tpu/rendering/bev_pair.py: `render_identity_batched`,
`render_transformed_batched`, the banks of the warp path
(`render_identity_banks`, one cloud a surface for the identity render and
the warp source), the pair batch of the corpus renderer,
`render_bev_pairs_batch_device`, and its host-array forms `render_bev_pair`
and `render_bev_pairs_batch`; the render config; and the host-side IO
helpers, which read images with the port's own JPEG and PNG readers
(native/), not imageio.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple, Tuple

import numpy as np
import torch

from salve_tpu_torch import device as device_mod
from salve_tpu_torch.geometry.sim2 import Sim2
from salve_tpu_torch.native import jpeg, png
from salve_tpu_torch.ops import backproject as bp
from salve_tpu_torch.ops import bev as bev_ops
from salve_tpu_torch.ops.numerics import fma_f32_exact
from salve_tpu_torch.ops.warp import pack_rgb888

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
    window = bp.surface_row_window(depths.shape[1], z_range, cfg.crop_ratio)
    xyz, c, v = bp.backproject_depth(depths, rgbs, z_range, cfg.crop_ratio, window)
    xyz = torch.stack([xyz[..., 1], -xyz[..., 0], xyz[..., 2]], dim=-1)
    return xyz, c, v


def _z_range_for_surface(surface_type: str) -> Tuple[float, float]:
    if surface_type == "floor":
        return bp.FLOOR_Z_RANGE
    if surface_type == "ceiling":
        return bp.CEILING_Z_RANGE
    raise ValueError(f"Unknown surface type: {surface_type}")


def _move_cloud(xyz: torch.Tensor, i2Ri1: torch.Tensor, i2ti1: torch.Tensor) -> torch.Tensor:
    """Carry (B, N, 3) clouds through (R, t * 1.5), as the reference's einsum
    followed by the scaled translation: XLA:CPU's dot accumulates j = 0, 1
    with a fused multiply-add, and the rounded t * 1.5 is added after."""
    x, y = xyz[..., 0], xyz[..., 1]
    R = i2Ri1.to(torch.float32)[:, None]
    t = (i2ti1.to(torch.float32) * HOHO_S_ZIND_SCALE_FACTOR)[:, None]
    out = [fma_f32_exact(*torch.broadcast_tensors(R[..., i, 1], y, R[..., i, 0] * x)) + t[..., i] for i in range(2)]
    return torch.stack([out[0], out[1], xyz[..., 2]], dim=-1)


def render_identity_batched(
    depths: torch.Tensor, rgbs: torch.Tensor, z_range: Tuple[float, float], cfg: BEVRenderConfig
) -> torch.Tensor:
    """Render (B, H, W) panos in their own frames -> (B, h, w, 3) uint8."""
    xyz, c, v = surface_clouds(depths, rgbs, z_range, cfg)
    return bev_ops.render_bev_images_batched(xyz, c, v, cfg.img_px, cfg.meters_per_px, cfg.is_semantics)


def render_identity_banks(
    depths: torch.Tensor, rgbs: torch.Tensor, z_range: Tuple[float, float], cfg: BEVRenderConfig, bank_px: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One surface's banks of the warp path from one backprojection: the
    (B, img_px+1, img_px+1, 3) uint8 identity render and the (B, bank_px+1,
    bank_px+1) int32 packed rgb888 warp source (salve_tpu's
    `render_identity_batched` and `ops/warp.py:render_identity_bank_extended`):
    the same points, splatted on both grids."""
    xyz, c, v = surface_clouds(depths, rgbs, z_range, cfg)
    identity = bev_ops.render_bev_images_batched(xyz, c, v, cfg.img_px, cfg.meters_per_px, cfg.is_semantics)
    bank = bev_ops.render_bev_images_batched(xyz, c, v, bank_px, cfg.meters_per_px, cfg.is_semantics)
    return identity, pack_rgb888(bank)


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
    xyz = _move_cloud(xyz, i2Ri1, i2ti1)
    return bev_ops.render_bev_images_batched(xyz, c, v, cfg.img_px, cfg.meters_per_px, cfg.is_semantics)


def render_bev_pairs_batch_device(
    depths: torch.Tensor,
    rgbs: torch.Tensor,
    pair_indices: np.ndarray,
    rotations: np.ndarray,
    translations: np.ndarray,
    surface_type: str,
    cfg: BEVRenderConfig = BEVRenderConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render a batch of hypothesis pairs against a pano bank on its device.

    Args:
        depths: (P, 512, 1024) float32 depth bank (mm); rgbs: (P, 512, 1024, 3).
        pair_indices: (B, 2) bank rows (i1, i2) of each pair.
        rotations: (B, 2, 2) i2Ri1; translations: (B, 2) i2ti1.

    Returns:
        (imgs1, imgs2): (B, h, w, 3) uint8 on the bank's device; img1 is pano
        1 rendered in pano 2's frame. Both panos of every pair fold into one
        2B render batch (salve_tpu's `_render_pairs_batched`): one B1 and one
        B2 launch a batch.
    """
    z_range = _z_range_for_surface(surface_type)
    dev = depths.device
    idx = torch.as_tensor(np.concatenate([pair_indices[:, 0], pair_indices[:, 1]]).astype(np.int64), device=dev)
    b = len(pair_indices)
    xyz, c, v = surface_clouds(depths[idx], rgbs[idx], z_range, cfg)
    xyz1 = _move_cloud(xyz[:b], torch.as_tensor(rotations, device=dev), torch.as_tensor(translations, device=dev))
    imgs = bev_ops.render_bev_images_batched(torch.cat([xyz1, xyz[b:]]), c, v, cfg.img_px, cfg.meters_per_px,
                                            cfg.is_semantics)
    return imgs[:b], imgs[b:]


def render_bev_pairs_batch(
    depths: np.ndarray,
    rgbs: np.ndarray,
    pair_indices: np.ndarray,
    rotations: np.ndarray,
    translations: np.ndarray,
    surface_type: str,
    cfg: BEVRenderConfig = BEVRenderConfig(),
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Render a batch of hypothesis pairs against a shared pano bank.

    Args:
        depths: (P, 512, 1024) depth bank (mm) of the P panos involved.
        rgbs: (P, 512, 1024, 3) float RGB bank in [0, 1].
        pair_indices: (B, 2) int: the bank rows (i1, i2) of each pair.
        rotations: (B, 2, 2) relative rotations i2Ri1.
        translations: (B, 2) relative translations i2ti1.
        surface_type: "floor" or "ceiling".
        device: where the render runs; None is the CUDA card.

    Returns:
        (imgs1, imgs2): (B, h, w, 3) uint8 numpy arrays, from one
        `render_bev_pairs_batch_device` call (one B1 and one B2 launch).
    """
    dev = device_mod.resolve_device(device)
    bank_d = torch.as_tensor(np.asarray(depths, dtype=np.float32), device=dev)
    bank_c = torch.as_tensor(np.asarray(rgbs, dtype=np.float32), device=dev)
    imgs1, imgs2 = render_bev_pairs_batch_device(
        bank_d, bank_c, np.asarray(pair_indices), np.asarray(rotations, dtype=np.float32),
        np.asarray(translations, dtype=np.float32), surface_type, cfg)
    return imgs1.cpu().numpy(), imgs2.cpu().numpy()


def render_bev_pair(
    depth1: np.ndarray,
    rgb1: np.ndarray,
    depth2: np.ndarray,
    rgb2: np.ndarray,
    i2Ti1: Sim2,
    surface_type: str,
    cfg: BEVRenderConfig = BEVRenderConfig(),
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Render one hypothesis pair: the batch form at B = 1.

    Args:
        depth1/depth2: (512, 1024) depth maps in millimeters.
        rgb1/rgb2: (512, 1024, 3) float RGB in [0, 1].
        i2Ti1: relative pose hypothesis (p_i2 = i2Ti1 * p_i1).
        surface_type: "floor" or "ceiling".
        device: where the render runs; None is the CUDA card.

    Returns:
        (img1, img2): (h, w, 3) uint8 texture maps; img1 rendered in i2's frame.
    """
    imgs1, imgs2 = render_bev_pairs_batch(
        np.stack([depth1, depth2]), np.stack([rgb1, rgb2]), np.array([[0, 1]]),
        i2Ti1.rotation[None], i2Ti1.translation[None], surface_type, cfg, device)
    return imgs1[0], imgs2[0]


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
