"""CLI: verifier accuracy vs layout-overlap analysis
(parity: scripts/measure_acc_vs_overlap.py).

A copy of salve_tpu/cli/measure_acc_vs_overlap.py (no JAX) on the standard
library's argparse, with the click original's flags. The overlap IoU is
`geometry/polygons.py:polygon_iou_and_overlap`, a numpy raster on the host,
so this CLI reaches no card and takes no `--device`:

    python -m salve_tpu_torch.cli.measure_acc_vs_overlap --serialized_preds_json_dir PREDS \\
        --hypotheses_save_root HYPS --raw_dataset_dir ZIND
"""

from __future__ import annotations

import argparse
import logging
from collections import defaultdict
from typing import List, Optional

import numpy as np

from salve_tpu_torch.cli.args import existing_path
from salve_tpu_torch.common import edge_classification, posegraph2d
from salve_tpu_torch.geometry.polygons import polygon_iou_and_overlap


def run_measure_acc_vs_overlap(
    serialized_preds_json_dir: str, hypotheses_save_root: str, raw_dataset_dir: str
) -> None:
    bins = np.array([0.0, 0.1, 0.2, 0.3, 0.5, 1.0])
    correct = defaultdict(int)
    total = defaultdict(int)

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
        for m in measurements:
            if m.i1 not in gt_pg.nodes or m.i2 not in gt_pg.nodes:
                continue
            poly1 = gt_pg.nodes[m.i1].room_vertices_global_2d
            poly2 = gt_pg.nodes[m.i2].room_vertices_global_2d
            iou, _ = polygon_iou_and_overlap(poly1, poly2)
            b = int(np.digitize(iou, bins)) - 1
            total[b] += 1
            correct[b] += int(m.y_hat == m.y_true)

    for b in sorted(total):
        lo, hi = bins[b], bins[min(b + 1, len(bins) - 1)]
        acc = correct[b] / total[b]
        print(f"overlap IoU [{lo:.1f},{hi:.1f}): acc {acc:.3f} over {total[b]} edges")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Bin verifier accuracy by GT room-layout overlap (IoU).")
    p.add_argument("--serialized_preds_json_dir", type=existing_path, required=True)
    p.add_argument("--hypotheses_save_root", type=existing_path, required=True)
    p.add_argument("--raw_dataset_dir", type=existing_path, required=True)
    return p


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    run_measure_acc_vs_overlap(args.serialized_preds_json_dir, args.hypotheses_save_root, args.raw_dataset_dir)


if __name__ == "__main__":
    main()
