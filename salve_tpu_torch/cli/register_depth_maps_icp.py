"""CLI: register two backprojected pano depth maps with colored ICP (port of
salve_tpu/cli/register_depth_maps_icp.py).

The same options as the click original, on argparse, plus `--device`
(default cuda; the CPU only when asked). Each cached u16 depth map and its
pano backproject through `ops/backproject.py` on the device; the clouds
register with `baselines/icp.py:register_colored_point_clouds`.

    python -m salve_tpu_torch.cli.register_depth_maps_icp --depth_fpath_1 D1.depth.png \\
        --rgb_fpath_1 P1.jpg --depth_fpath_2 D2.depth.png --rgb_fpath_2 P2.jpg [--save_fpath T.npy] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np

from salve_tpu_torch.cli.args import existing_path
from salve_tpu_torch.device import DeviceLike


def backproject_pano(depth_fpath: str, rgb_fpath: str, device: DeviceLike = None) -> np.ndarray:
    """(N, 6) float32 xyzrgb cloud of a cached depth map and its pano, every
    row of the pano (no surface window), on `device` (None: the card)."""
    import torch

    from salve_tpu_torch.device import resolve_device
    from salve_tpu_torch.ops.backproject import backproject_depth
    from salve_tpu_torch.rendering.bev_pair import load_depth_mm, load_pano_rgb

    dev = resolve_device(device)
    depth = torch.as_tensor(load_depth_mm(depth_fpath).astype(np.float32), device=dev)
    rgb = torch.as_tensor(load_pano_rgb(rgb_fpath), dtype=torch.float32, device=dev)
    xyz, colors, valid = backproject_depth(depth[None], rgb[None], (-np.inf, np.inf))
    xyz, colors, valid = xyz[0].cpu().numpy(), colors[0].cpu().numpy(), valid[0].cpu().numpy()
    return np.hstack([xyz[valid], colors[valid]])


def register_depth_maps(depth_fpath_1: str, rgb_fpath_1: str, depth_fpath_2: str, rgb_fpath_2: str,
                        device: DeviceLike = None) -> np.ndarray:
    """The 4x4 transform 2T1 that registers pano 1's cloud to pano 2's."""
    from salve_tpu_torch.baselines.icp import register_colored_point_clouds

    cloud1 = backproject_pano(depth_fpath_1, rgb_fpath_1, device)
    cloud2 = backproject_pano(depth_fpath_2, rgb_fpath_2, device)
    return register_colored_point_clouds(cloud1, cloud2, device=device)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Register two backprojected pano point clouds with colored ICP.")
    p.add_argument("--depth_fpath_1", type=existing_path, required=True)
    p.add_argument("--rgb_fpath_1", type=existing_path, required=True)
    p.add_argument("--depth_fpath_2", type=existing_path, required=True)
    p.add_argument("--rgb_fpath_2", type=existing_path, required=True)
    p.add_argument("--save_fpath", type=str, default=None, help="Where to save the 4x4 transform (npy).")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu.")
    return p


def main(argv: Optional[List[str]] = None) -> np.ndarray:
    args = build_parser().parse_args(argv)
    tTs = register_depth_maps(args.depth_fpath_1, args.rgb_fpath_1, args.depth_fpath_2, args.rgb_fpath_2,
                              device=args.device)
    print(f"Estimated transform (2T1):\n{np.array_str(tTs, precision=4)}")
    if args.save_fpath:
        np.save(args.save_fpath, tTs)
    return tTs


if __name__ == "__main__":
    main()
