"""CLI: render verifier verdicts as multigraphs over GT poses
(parity: scripts/visualize_edge_classifications.py).

A copy of salve_tpu/cli/visualize_edge_classifications.py (no JAX) on the
standard library's argparse, with the click original's flags; host code.
The multigraphs are the product: without matplotlib it raises
`plotting.MatplotlibMissing` before it reads or writes anything. Each
floor's `batch_*.json` files are read in sorted order
(`common/edge_classification.py`).

    python -m salve_tpu_torch.cli.visualize_edge_classifications --serialized_preds_json_dir PREDS \\
        --hypotheses_save_root HYPS --raw_dataset_dir ZIND --save_dir OUT
"""

from __future__ import annotations

import argparse
import logging
from typing import List, Optional

from salve_tpu_torch.cli.args import existing_path
from salve_tpu_torch.common import edge_classification, posegraph2d
from salve_tpu_torch.utils import plotting
from salve_tpu_torch.utils.graph_rendering_utils import draw_multigraph


def run_visualize_edge_classifications(
    serialized_preds_json_dir: str, hypotheses_save_root: str, raw_dataset_dir: str,
    confidence_threshold: float = 0.93, save_dir: str = "multigraph_visualizations",
) -> None:
    """One multigraph a floor of every above-threshold positive verdict."""
    plotting.require("visualize_edge_classifications")
    pairs = edge_classification.get_available_floor_ids_building_ids_from_serialized_preds(
        serialized_preds_json_dir
    )
    for building_id, floor_id in sorted(pairs):
        ec_dict = edge_classification.get_edge_classifications_from_serialized_preds(
            building_id, floor_id, serialized_preds_json_dir, hypotheses_save_root
        )
        measurements = ec_dict[(building_id, floor_id)]
        if not measurements:
            continue
        gt_pg = posegraph2d.get_gt_pose_graph(building_id, floor_id, raw_dataset_dir)
        draw_multigraph(
            measurements, gt_pg,
            confidence_threshold=confidence_threshold, save_dir=save_dir,
        )
        print(f"Rendered {building_id} {floor_id}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Visualize verifier edge classifications as multigraphs.")
    p.add_argument("--serialized_preds_json_dir", type=existing_path, required=True)
    p.add_argument("--hypotheses_save_root", type=existing_path, required=True)
    p.add_argument("--raw_dataset_dir", type=existing_path, required=True)
    p.add_argument("--confidence_threshold", type=float, default=0.93)
    p.add_argument("--save_dir", type=str, default="multigraph_visualizations")
    return p


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    run_visualize_edge_classifications(args.serialized_preds_json_dir, args.hypotheses_save_root,
                                       args.raw_dataset_dir, args.confidence_threshold, args.save_dir)


if __name__ == "__main__":
    main()
