"""Rasterized room-layout rendering (the verifier's "layout" modality).

Port of salve_tpu/rendering/layout.py: the room polygon is filled white,
each W/D/O segment is drawn as a thick anti-aliased line (windows red, doors
green, openings blue), and the image is flipped vertically. The reference's
rasters are plain XLA, so their port is plain torch (ops/raster.py),
float32 op for op as XLA:CPU computes them: the u8 images after round/clip
equal the reference's exactly.

`rasterize_layout_device` renders a batch natively (no vmap): layouts are
padded to common vertex and W/D/O counts, and every render function of host
arrays takes `device=None`, which means the CUDA card;
`rasterize_layout_batch_device` renders on its tensors' device.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from salve_tpu_torch import device as device_mod
from salve_tpu_torch.common.pano_data import PanoData
from salve_tpu_torch.geometry.sim2 import Sim2
from salve_tpu_torch.ops import bev as bev_ops
from salve_tpu_torch.ops import raster
from salve_tpu_torch.ops.numerics import div_const, fma_f32

HOHO_S_ZIND_SCALE_FACTOR = 1.5

WDO_COLORS = {
    "windows": np.array([255.0, 0.0, 0.0]),
    "doors": np.array([0.0, 255.0, 0.0]),
    "openings": np.array([0.0, 0.0, 255.0]),
}
WHITE = 255.0

# Default padded sizes; raised to the largest layout of a call.
MAX_ROOM_VERTS = 64
MAX_WDOS = 16

# Line width at 0.02 m/px: 30 px at full-res 0.005 m/px -> 30/4 = 7.5 -> 8
# (salve/common/bevparams.py:81-99).
FULL_RES_METERS_PER_PX = 0.005
FULL_RES_LINE_WIDTH_PX = 30


def get_line_width_by_resolution(resolution: float) -> int:
    """Polyline thickness in px for a rendering resolution (bevparams.py:81)."""
    scale = resolution / FULL_RES_METERS_PER_PX
    return max(round(FULL_RES_LINE_WIDTH_PX / scale), 1)


def _world_to_img(p: torch.Tensor, half_m: float, meters_per_px: float) -> torch.Tensor:
    """(p * 1.5 + half_m) / mpp as XLA:CPU computes it: one fused
    multiply-add, then the product with mpp's float32 reciprocal."""
    return div_const(fma_f32(p, HOHO_S_ZIND_SCALE_FACTOR, half_m), meters_per_px)


def rasterize_layout_device(
    room_verts: torch.Tensor,
    num_room_verts: torch.Tensor,
    wdo_segments: torch.Tensor,
    wdo_colors: torch.Tensor,
    num_wdos: torch.Tensor,
    img_px: int = bev_ops.DEFAULT_BEV_IMG_PX,
    meters_per_px: float = bev_ops.DEFAULT_METERS_PER_PX,
) -> torch.Tensor:
    """Render a batch of layouts: filled room masks + thick W/D/O segments.

    Args:
        room_verts: (B, V, 2) float32 world coords, padded.
        num_room_verts: (B,) real vertex counts.
        wdo_segments: (B, K, 2, 2) float32 world coords of W/D/O endpoints, padded.
        wdo_colors: (B, K, 3) float32 RGB of each W/D/O.
        num_wdos: (B,) real W/D/O counts.

    Returns:
        (B, img_px+1, img_px+1, 3) float32 images, flipped vertically, on
        the inputs' device.
    """
    img_h = img_w = img_px + 1
    dev = room_verts.device
    half_m = float(int((img_px / 2) * meters_per_px))
    thickness = float(get_line_width_by_resolution(meters_per_px))
    counts = torch.as_tensor(num_wdos)
    # Padded W/D/Os paint with coverage 0, which leaves every pixel as it
    # is: only the first max(num_wdos) slots are drawn.
    k_max = int(counts.max()) if counts.numel() else 0
    num_wdos = counts.to(dev)

    mask = raster.polygon_mask(_world_to_img(room_verts, half_m, meters_per_px), num_room_verts, img_h, img_w)
    img = torch.where(mask[..., None], WHITE, 0.0).expand(*mask.shape, 3)
    seg_img = _world_to_img(wdo_segments, half_m, meters_per_px)  # (B, K, 2, 2)
    two = torch.full(mask.shape[:1], 2, dtype=torch.long, device=dev)
    for k in range(min(k_max, wdo_segments.shape[1])):
        cov = raster.polyline_coverage(seg_img[:, k], two, thickness, img_h, img_w)
        cov = torch.where((k < num_wdos)[:, None, None], cov, torch.zeros((), device=dev))
        img = raster.paint_rgb(img, cov, wdo_colors[:, k])
    return img.flip(-3)


def _pad_layout(
    room_verts: np.ndarray, wdos: List, max_verts: int, max_wdos: int
) -> Tuple[np.ndarray, int, np.ndarray, np.ndarray, int]:
    """Pad one layout's arrays to static sizes (salve_tpu's `_pad_layout`)."""
    v = np.zeros((max_verts, 2), dtype=np.float32)
    n_v = min(room_verts.shape[0], max_verts)
    v[:n_v] = room_verts[:n_v]

    segs = np.zeros((max_wdos, 2, 2), dtype=np.float32)
    colors = np.zeros((max_wdos, 3), dtype=np.float32)
    n_w = min(len(wdos), max_wdos)
    for k in range(n_w):
        segs[k] = wdos[k].vertices_local_2d
        colors[k] = WDO_COLORS[wdos[k].type]
    return v, n_v, segs, colors, n_w


def rasterize_layout_batch_device(
    room_verts: torch.Tensor,
    num_room_verts: torch.Tensor,
    wdo_segments: torch.Tensor,
    wdo_colors: torch.Tensor,
    num_wdos: torch.Tensor,
    img_px: int = bev_ops.DEFAULT_BEV_IMG_PX,
    meters_per_px: float = bev_ops.DEFAULT_METERS_PER_PX,
) -> torch.Tensor:
    """`rasterize_layout_device` rounded, clipped and cast to uint8 on the
    inputs' device (salve_tpu/rendering/layout.py:137), so the fetched
    array is 4x smaller."""
    imgs = rasterize_layout_device(room_verts, num_room_verts, wdo_segments, wdo_colors, num_wdos, img_px,
                                   meters_per_px)
    return torch.clamp(torch.round(imgs), 0, 255).to(torch.uint8)


def _stack_padded(padded, dev: torch.device) -> Tuple[torch.Tensor, ...]:
    """`rasterize_layout_batch_device`'s five inputs from `_pad_layout` rows:
    the coordinates and colours on `dev`, the counts on the host."""
    return (
        torch.as_tensor(np.stack([p[0] for p in padded]), device=dev),
        torch.as_tensor(np.array([p[1] for p in padded], dtype=np.int64)),
        torch.as_tensor(np.stack([p[2] for p in padded]), device=dev),
        torch.as_tensor(np.stack([p[3] for p in padded]), device=dev),
        torch.as_tensor(np.array([p[4] for p in padded], dtype=np.int64)),
    )


def rasterize_single_layout(
    room_vertices: np.ndarray,
    wdo_objs: List,
    img_px: int = bev_ops.DEFAULT_BEV_IMG_PX,
    meters_per_px: float = bev_ops.DEFAULT_METERS_PER_PX,
    device=None,
) -> np.ndarray:
    """Render one room layout to (H, W, 3) uint8."""
    dev = device_mod.resolve_device(device)
    max_verts = max(MAX_ROOM_VERTS, room_vertices.shape[0])
    max_wdos = max(MAX_WDOS, len(wdo_objs))
    padded = [_pad_layout(room_vertices, wdo_objs, max_verts, max_wdos)]
    return rasterize_layout_batch_device(*_stack_padded(padded, dev), img_px, meters_per_px)[0].cpu().numpy()


def rasterize_layout_batch(
    layouts: List[Tuple[np.ndarray, List]],
    img_px: int = bev_ops.DEFAULT_BEV_IMG_PX,
    meters_per_px: float = bev_ops.DEFAULT_METERS_PER_PX,
    chunk: int = 64,
    on_chunk: Optional[Callable[[int, np.ndarray], None]] = None,
    device=None,
) -> "np.ndarray | None":
    """Render many layouts in chunks of `chunk`.

    Args:
        layouts: list of (room_vertices (V,2), wdo_objs) — the per-layout
            inputs of rasterize_single_layout.
        on_chunk: optional callback (start_index, imgs_u8) called with each
            chunk as it reaches the host, so that its IO overlaps the next
            chunk's render; the function then returns None instead of the
            full array.

    Returns:
        (N, img_px+1, img_px+1, 3) uint8, or None when on_chunk is given.

    Each chunk renders on the device and is copied to pinned host memory
    without blocking, on the card's stream; the chunk before it is handed
    to `on_chunk` while this one renders.
    """
    dev = device_mod.resolve_device(device)
    if not layouts:
        return None if on_chunk else np.zeros((0, img_px + 1, img_px + 1, 3), dtype=np.uint8)
    max_verts = max([MAX_ROOM_VERTS] + [rv.shape[0] for rv, _ in layouts])
    max_wdos = max([MAX_WDOS] + [len(w) for _, w in layouts])

    out = None
    if on_chunk is None:
        out = np.zeros((len(layouts), img_px + 1, img_px + 1, 3), dtype=np.uint8)

        def on_chunk(start, imgs):
            out[start : start + imgs.shape[0]] = imgs

    pending = None  # (start, host tensor, event)

    def deliver(p):
        start, host, event = p
        if event is not None:
            event.synchronize()
        on_chunk(start, host.numpy())

    for start in range(0, len(layouts), chunk):
        padded = [_pad_layout(rv, w, max_verts, max_wdos) for rv, w in layouts[start : start + chunk]]
        imgs = rasterize_layout_batch_device(*_stack_padded(padded, dev), img_px, meters_per_px)
        event = None
        if dev.type == "cuda":
            host = torch.empty(imgs.shape, dtype=imgs.dtype, pin_memory=True)
            host.copy_(imgs, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host = imgs
        if pending is not None:
            deliver(pending)
        pending = (start, host, event)
    deliver(pending)
    return out


def layout_pair_inputs(
    i2Ti1: Sim2, pano1: PanoData, pano2: PanoData
) -> Tuple[Tuple[np.ndarray, List], Tuple[np.ndarray, List]]:
    """The two (room_vertices, wdos) layout jobs of a hypothesis pair.

    Pano 1's geometry is moved through i2Ti1 into pano 2's frame
    (bev_rendering_utils.py:48); pano 2's is used as-is.
    """
    i1_verts = i2Ti1.transform_from(pano1.room_vertices_local_2d)
    i1_wdos = [w.transform_from(i2Ti1) for w in pano1.all_wdos]
    return (i1_verts, i1_wdos), (pano2.room_vertices_local_2d, pano2.all_wdos)


def rasterize_room_layout_pair(
    i2Ti1: Sim2, pano1: PanoData, pano2: PanoData, device=None
) -> Tuple[np.ndarray, np.ndarray]:
    """Rasterize both panos' layouts in pano 2's frame, one render each
    (salve_tpu/rendering/layout.py:241): pano 1's room polygon and W/D/Os
    are moved through i2Ti1; pano 2's are already in frame i2. `device=None`
    is the CUDA card."""
    job1, job2 = layout_pair_inputs(i2Ti1, pano1, pano2)
    return (rasterize_single_layout(*job1, device=device), rasterize_single_layout(*job2, device=device))
