"""CLI: evaluate oracle-pose + predicted-layout floorplans (parity: scripts/eval_floorplan.py).

A copy of salve_tpu/cli/eval_floorplan.py (no JAX) on the standard
library's argparse, with the click original's flags plus `--device`: each
floor's report (the RANSAC Sim(3) alignment and the raster IoU) runs there,
on the CUDA card by default, and raises without one.

    python -m salve_tpu_torch.cli.eval_floorplan --raw_dataset_dir ZIND \\
        --mhnet_predictions_data_root MHNET [--split test] [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import logging
from pathlib import Path
from typing import List, Optional

from salve_tpu_torch.cli.args import existing_path
from salve_tpu_torch.common import posegraph2d
from salve_tpu_torch.common.floor_reconstruction_report import (
    FloorReconstructionReport,
    summarize_reports,
)
from salve_tpu_torch.common.posegraph2d import PoseGraph2d
from salve_tpu_torch.dataset import hnet_prediction_loader
from salve_tpu_torch.dataset.zind_partition import DATASET_SPLITS
from salve_tpu_torch.device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)


def eval_oraclepose_predictedlayout(
    raw_dataset_dir: str,
    predictions_data_root: str,
    split: str,
    viz_save_dir: str,
    device: DeviceLike = None,
) -> list:
    """GT poses + inferred MHNet layouts vs GT floorplan (upper bound), each
    floor's report on `device` (None: the card)."""
    dev = resolve_device(device)
    reports = []
    building_ids = sorted(
        Path(p).stem for p in glob.glob(f"{raw_dataset_dir}/*") if Path(p).is_dir()
    )
    for building_id in building_ids:
        if building_id not in DATASET_SPLITS[split]:
            continue
        floor_pose_graphs = hnet_prediction_loader.load_inferred_floor_pose_graphs(
            building_id=building_id,
            raw_dataset_dir=raw_dataset_dir,
            predictions_data_root=predictions_data_root,
        )
        if floor_pose_graphs is None:
            continue
        for floor_id, inferred_pg in floor_pose_graphs.items():
            gt_pg = posegraph2d.get_gt_pose_graph(building_id, floor_id, raw_dataset_dir)
            # Oracle poses: GT poses with inferred layouts.
            est_pg = PoseGraph2d.from_aligned_est_poses_and_inferred_layouts(
                gt_pg, inferred_pg
            )
            reports.append(
                FloorReconstructionReport.from_est_floor_pose_graph(
                    est_pg, gt_pg, plot_save_dir=viz_save_dir, device=dev
                )
            )
    return reports


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluate oracle-pose + predicted-layout floorplans against GT.")
    p.add_argument("--raw_dataset_dir", type=existing_path, required=True)
    p.add_argument("--mhnet_predictions_data_root", type=existing_path, required=True)
    p.add_argument("--split", choices=["train", "val", "test"], default="test")
    p.add_argument("--viz_save_dir", type=str, default="oraclepose_predicted_layout")
    p.add_argument("--device", type=str, default="cuda",
                   help="Where the reports' RANSAC and raster IoU run ('cuda' or 'cpu'; default: cuda).")
    return p


def main(argv: Optional[List[str]] = None) -> list:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    reports = eval_oraclepose_predictedlayout(
        args.raw_dataset_dir, args.mhnet_predictions_data_root, args.split, args.viz_save_dir, device=args.device
    )
    for k, v in summarize_reports(reports).items():
        print(f"{k} = {v:.3f}")
    return reports


if __name__ == "__main__":
    main()
