"""CLI: render inferred MHNet layouts at GT poses
(parity: scripts/visualize_inferred_layout_w_gt_poses.py).

A copy of salve_tpu/cli/visualize_inferred_layout_w_gt_poses.py (no JAX) on
the standard library's argparse, with the click original's flags; host
code. The renders are the product: without matplotlib it raises
`plotting.MatplotlibMissing` before it reads or writes anything.

    python -m salve_tpu_torch.cli.visualize_inferred_layout_w_gt_poses --raw_dataset_dir ZIND \\
        --mhnet_predictions_data_root MHNET --building_id 0000 --save_dir OUT
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

from salve_tpu_torch.cli.args import existing_path
from salve_tpu_torch.common import posegraph2d
from salve_tpu_torch.common.floor_reconstruction_report import render_floorplans_side_by_side
from salve_tpu_torch.common.posegraph2d import PoseGraph2d
from salve_tpu_torch.dataset import hnet_prediction_loader
from salve_tpu_torch.utils import plotting


def run_visualize_inferred_layout_w_gt_poses(
    raw_dataset_dir: str, mhnet_predictions_data_root: str, building_id: str,
    save_dir: str = "inferred_layout_w_gt_poses",
) -> None:
    """Each floor's inferred layouts placed at the GT poses, next to the GT floorplan."""
    plotting.require("visualize_inferred_layout_w_gt_poses")
    os.makedirs(save_dir, exist_ok=True)
    floor_pose_graphs = hnet_prediction_loader.load_inferred_floor_pose_graphs(
        building_id=building_id,
        raw_dataset_dir=raw_dataset_dir,
        predictions_data_root=mhnet_predictions_data_root,
    )
    for floor_id, inferred_pg in (floor_pose_graphs or {}).items():
        gt_pg = posegraph2d.get_gt_pose_graph(building_id, floor_id, raw_dataset_dir)
        est_pg = PoseGraph2d.from_aligned_est_poses_and_inferred_layouts(gt_pg, inferred_pg)
        render_floorplans_side_by_side(
            est_pg, save_plot=True, plot_save_dir=save_dir, gt_floor_pg=gt_pg
        )
        print(f"Rendered {building_id} {floor_id}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Render inferred layouts placed at GT poses, next to GT floorplan.")
    p.add_argument("--raw_dataset_dir", type=existing_path, required=True)
    p.add_argument("--mhnet_predictions_data_root", type=existing_path, required=True)
    p.add_argument("--building_id", type=str, required=True)
    p.add_argument("--save_dir", type=str, default="inferred_layout_w_gt_poses")
    return p


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    run_visualize_inferred_layout_w_gt_poses(args.raw_dataset_dir, args.mhnet_predictions_data_root,
                                             args.building_id, args.save_dir)


if __name__ == "__main__":
    main()
