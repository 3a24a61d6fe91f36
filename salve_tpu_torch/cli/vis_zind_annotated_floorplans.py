"""CLI: render GT annotated floorplans (parity: scripts/vis_zind_annotated_floorplans.py).

A copy of salve_tpu/cli/vis_zind_annotated_floorplans.py (no JAX) on the
standard library's argparse, with the click original's flags; host code.
The renders are the product: without matplotlib it raises
`plotting.MatplotlibMissing` before it reads or writes anything.

    python -m salve_tpu_torch.cli.vis_zind_annotated_floorplans --raw_dataset_dir ZIND --save_dir OUT
"""

from __future__ import annotations

import argparse
import glob
import os
from pathlib import Path
from typing import List, Optional

from salve_tpu_torch.cli.args import existing_path
from salve_tpu_torch.common import posegraph2d
from salve_tpu_torch.common.floor_reconstruction_report import render_floorplans_side_by_side
from salve_tpu_torch.utils import plotting


def run_vis_zind_annotated_floorplans(
    raw_dataset_dir: str, save_dir: str = "zind_gt_floorplans", building_id: Optional[str] = None
) -> None:
    """Render every (or one) building's GT floorplans, one JPG a floor."""
    plotting.require("vis_zind_annotated_floorplans")
    os.makedirs(save_dir, exist_ok=True)
    if building_id:
        building_ids = [building_id]
    else:
        building_ids = sorted(
            Path(p).stem for p in glob.glob(f"{raw_dataset_dir}/*") if Path(p).is_dir()
        )
    for bid in building_ids:
        try:
            floor_ids = posegraph2d.compute_available_floors_for_building(bid, raw_dataset_dir)
        except (FileNotFoundError, KeyError):
            continue
        for floor_id in floor_ids:
            gt_pg = posegraph2d.get_gt_pose_graph(bid, floor_id, raw_dataset_dir)
            render_floorplans_side_by_side(
                gt_pg, save_plot=True, plot_save_dir=save_dir, gt_floor_pg=gt_pg
            )
            print(f"Rendered {bid} {floor_id}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Render ZInD GT annotated floorplans to images.")
    p.add_argument("--raw_dataset_dir", type=existing_path, required=True)
    p.add_argument("--save_dir", type=str, default="zind_gt_floorplans")
    p.add_argument("--building_id", type=str, default=None)
    return p


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    run_vis_zind_annotated_floorplans(args.raw_dataset_dir, args.save_dir, args.building_id)


if __name__ == "__main__":
    main()
