"""CLI: visualize a backprojected depth map as BEV texture maps
(parity: scripts/visualize_backprojected_depthmap.py).

A copy of salve_tpu/cli/visualize_backprojected_depthmap.py (no JAX) on the
standard library's argparse, with the click original's flags plus
`--device`. `backprojected_bev_images` backprojects the cached depth map and
renders the floor and ceiling textures on the device (B1 and B2 once each a
surface), on the CUDA card by default, raising without one; the figure of
the two is the product: without matplotlib the CLI raises
`plotting.MatplotlibMissing` before it reads or writes anything.

    python -m salve_tpu_torch.cli.visualize_backprojected_depthmap --depth_fpath DEPTH.png \\
        --rgb_fpath PANO.jpg --save_fpath OUT.png [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Tuple

import numpy as np
import torch

from salve_tpu_torch.cli.args import existing_path
from salve_tpu_torch.device import DeviceLike, resolve_device
from salve_tpu_torch.ops import bev as bev_ops
from salve_tpu_torch.ops.backproject import CEILING_Z_RANGE, FLOOR_Z_RANGE, backproject_depth
from salve_tpu_torch.rendering.bev_pair import load_depth_mm, load_pano_rgb
from salve_tpu_torch.utils import plotting


def backprojected_bev_images(
    depth_fpath: str, rgb_fpath: str, device: DeviceLike = None
) -> List[Tuple[str, np.ndarray]]:
    """[("floor", img), ("ceiling", img)]: a pano's (H, W, 3) uint8 BEV
    textures at the default 501^2 grid, rendered on `device` (None: the card)."""
    dev = resolve_device(device)
    depth = torch.as_tensor(np.asarray(load_depth_mm(depth_fpath), dtype=np.float32), device=dev)
    rgb = torch.as_tensor(np.asarray(load_pano_rgb(rgb_fpath), dtype=np.float32), device=dev)
    images = []
    for title, z_range in [("floor", FLOOR_Z_RANGE), ("ceiling", CEILING_Z_RANGE)]:
        xyz, colors, valid = backproject_depth(depth[None], rgb[None], z_range)
        images.append((title, bev_ops.render_bev_image(xyz[0], colors[0], valid[0]).cpu().numpy()))
    return images


def draw_bev_images(images: List[Tuple[str, np.ndarray]], save_fpath: str) -> None:
    """The textures side by side, titled, saved to `save_fpath`."""
    plt = plotting.pyplot("visualize_backprojected_depthmap")

    plt.figure(figsize=(12, 6))
    for i, (title, img) in enumerate(images):
        plt.subplot(1, 2, i + 1)
        plt.imshow(img)
        plt.title(title)
    plt.tight_layout()
    plt.savefig(save_fpath, dpi=200)
    print(f"Saved to {save_fpath}")


def run_visualize_backprojected_depthmap(
    depth_fpath: str, rgb_fpath: str, save_fpath: str = "backprojected_bev.png", device: DeviceLike = None
) -> None:
    """Render a cached depth map's floor and ceiling textures and draw them."""
    plotting.require("visualize_backprojected_depthmap")
    draw_bev_images(backprojected_bev_images(depth_fpath, rgb_fpath, device), save_fpath)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Backproject a cached depth map and render its BEV texture maps.")
    p.add_argument("--depth_fpath", type=existing_path, required=True)
    p.add_argument("--rgb_fpath", type=existing_path, required=True)
    p.add_argument("--save_fpath", type=str, default="backprojected_bev.png")
    p.add_argument("--device", type=str, default="cuda",
                   help="Where the backprojection and renders run ('cuda' or 'cpu'; default: cuda).")
    return p


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    run_visualize_backprojected_depthmap(args.depth_fpath, args.rgb_fpath, args.save_fpath, device=args.device)


if __name__ == "__main__":
    main()
