"""Depth-map cache with the reference's on-disk contract (the cache-hit path
of salve_tpu/depth/cache.py).

Depth maps are u16 PNGs in millimeters at (512, 1024), cached per building.
The depth model itself comes with the depth slice of the port; until then a
cache miss raises.
"""

from __future__ import annotations

from pathlib import Path


def depth_fpath_for_pano(depth_save_root: str, building_id: str, img_fpath: str) -> str:
    """Cache path: {depth_save_root}/{building_id}/{stem}.depth.png."""
    return f"{depth_save_root}/{building_id}/{Path(img_fpath).stem}.depth.png"


def infer_depth_if_nonexistent(depth_save_root: str, building_id: str, img_fpath: str) -> str:
    """Return the cached depth map's path; raise FileNotFoundError on a miss."""
    depth_fpath = depth_fpath_for_pano(depth_save_root, building_id, img_fpath)
    if Path(depth_fpath).exists():
        return depth_fpath
    raise FileNotFoundError(
        f"No cached depth map at {depth_fpath}. Pre-compute depth PNGs "
        "(u16 mm, 512x1024); the port has no depth model yet."
    )
