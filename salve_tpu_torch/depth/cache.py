"""Depth-map cache with the reference's on-disk contract (port of
salve_tpu/depth/cache.py).

Depth maps are u16 PNGs in millimeters at (512, 1024), cached per building
under {depth_save_root}/{building_id}/{pano_stem}.depth.png. A cache hit
returns the path; a miss runs the registered depth producer (a HoHoNet or
PanoDepthNet provider from `models/`) on the resized pano and writes its
PNG through the port's own encoder (native/png.py).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

# Registered producer: fn(rgb (512,1024,3) float [0,1]) -> depth_m (512,1024) float.
_DEPTH_MODEL: Optional[Callable[[np.ndarray], np.ndarray]] = None

PANO_H, PANO_W = 512, 1024


def meters_to_mm(depth_m: torch.Tensor) -> torch.Tensor:
    """The cache's millimetres: round(depth_m * 1000), half to even, clipped
    to [0, 65535], in depth_m's dtype and on its device. The scorer's depth
    computed on the card (pipeline/fused_inference.py:depth_mm_bank) and the PNGs
    written here both go through it."""
    return torch.clamp(torch.round(depth_m * 1000.0), 0, 65535)


def register_depth_model(fn: Optional[Callable[[np.ndarray], np.ndarray]]) -> None:
    """Register the depth producer used on cache misses (None: none)."""
    global _DEPTH_MODEL
    _DEPTH_MODEL = fn


def depth_fpath_for_pano(depth_save_root: str, building_id: str, img_fpath: str) -> str:
    """Cache path: {depth_save_root}/{building_id}/{stem}.depth.png."""
    return f"{depth_save_root}/{building_id}/{Path(img_fpath).stem}.depth.png"


def infer_depth_if_nonexistent(depth_save_root: str, building_id: str, img_fpath: str) -> str:
    """Ensure a cached depth map exists for this pano; return its path.

    On a miss, runs the registered producer on the pano (read and resized
    to 512x1024 by `load_pano_rgb`) and writes its depth as a u16 mm PNG
    (`meters_to_mm`, on the host). Raises
    FileNotFoundError if no producer is registered and no cache exists.
    """
    depth_fpath = depth_fpath_for_pano(depth_save_root, building_id, img_fpath)
    if Path(depth_fpath).exists():
        return depth_fpath

    if _DEPTH_MODEL is None:
        raise FileNotFoundError(
            f"No cached depth map at {depth_fpath} and no depth model registered. "
            "Pre-compute depth PNGs (u16 mm, 512x1024) or call "
            "salve_tpu_torch.depth.register_depth_model()."
        )

    from salve_tpu_torch.native import png
    from salve_tpu_torch.rendering.bev_pair import load_pano_rgb

    rgb = load_pano_rgb(img_fpath)
    depth_m = np.asarray(_DEPTH_MODEL(rgb))
    if depth_m.shape != (PANO_H, PANO_W):
        raise ValueError(f"Depth model returned shape {depth_m.shape}")
    depth_mm = meters_to_mm(torch.as_tensor(depth_m)).numpy().astype(np.uint16)
    os.makedirs(os.path.dirname(depth_fpath), exist_ok=True)
    Path(depth_fpath).write_bytes(png.encode_png(depth_mm))
    return depth_fpath
