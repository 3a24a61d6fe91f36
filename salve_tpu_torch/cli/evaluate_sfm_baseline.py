"""CLI: evaluate OpenSfM/OpenMVG reconstructions vs GT (parity: scripts/evaluate_sfm_baseline.py).

A copy of salve_tpu/cli/evaluate_sfm_baseline.py (no JAX) on the standard
library's argparse, with the click original's flags plus `--device`: each
floor's RANSAC Sim(3) alignment and report run there, on the CUDA card by
default, and it raises without one. `--visualize_3d` needs matplotlib.

    python -m salve_tpu_torch.cli.evaluate_sfm_baseline --raw_dataset_dir ZIND \\
        --results_dir RESULTS --algorithm_name opensfm --save_dir OUT [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import logging
from pathlib import Path
from typing import List, Optional

from salve_tpu_torch.baselines.sfm_eval import (
    analyze_algorithm_results,
    measure_algorithm_localization_accuracy,
)
from salve_tpu_torch.cli.args import existing_path
from salve_tpu_torch.common.floor_reconstruction_report import summarize_reports
from salve_tpu_torch.device import DeviceLike, resolve_device


def run_evaluate_sfm_baseline(
    raw_dataset_dir: str,
    results_dir: str,
    algorithm_name: str,
    save_dir: str,
    visualize_3d: bool = False,
    device: DeviceLike = None,
) -> list:
    """Evaluate every ZinD_{building}_{floor}__{algorithm_name} directory
    under `results_dir` on `device` (None: the card) and print the summary
    and the corpus rollup; returns the floors' reports."""
    dev = resolve_device(device)
    reports = []
    for floor_dir in sorted(glob.glob(f"{results_dir}/ZinD_*__{algorithm_name}")):
        stem = Path(floor_dir).name  # ZinD_{bid}_{floor_id}__{algo}
        parts = stem.split("__")[0].split("_")
        building_id, floor_id = parts[1], "_".join(parts[2:])
        if algorithm_name == "opensfm":
            recon_fpath = f"{floor_dir}/reconstruction.json"
        else:
            recon_fpath = f"{floor_dir}/reconstruction/sfm_data.json"
        report = measure_algorithm_localization_accuracy(
            building_id=building_id,
            floor_id=floor_id,
            raw_dataset_dir=raw_dataset_dir,
            algorithm_name=algorithm_name,
            save_dir=save_dir,
            reconstruction_json_fpath=recon_fpath,
            visualize_3d=visualize_3d,
            device=dev,
        )
        reports.append(report)

    summary = summarize_reports(reports)
    for k, v in summary.items():
        print(f"{k} = {v:.3f}")
    corpus = analyze_algorithm_results(raw_dataset_dir, f"{save_dir}/result_summaries")
    print(str(corpus))
    return reports


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluate OpenSfM/OpenMVG reconstructions against ZInD GT poses.")
    p.add_argument("--raw_dataset_dir", type=existing_path, required=True)
    p.add_argument("--results_dir", type=existing_path, required=True,
                   help="Directory with per-floor reconstruction outputs "
                        "(ZinD_{building}_{floor}__{algo} subdirectories).")
    p.add_argument("--algorithm_name", choices=["opensfm", "openmvg"], required=True)
    p.add_argument("--save_dir", type=str, required=True)
    p.add_argument("--visualize_3d", action="store_true", default=False,
                   help="Save before/after-alignment 3D pose-graph renderings (visualization/pose_viz.py; "
                        "needs matplotlib).")
    p.add_argument("--device", type=str, default="cuda",
                   help="Where the alignment and the reports run ('cuda' or 'cpu'; default: cuda).")
    return p


def main(argv: Optional[List[str]] = None) -> list:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    return run_evaluate_sfm_baseline(args.raw_dataset_dir, args.results_dir, args.algorithm_name, args.save_dir,
                                     args.visualize_3d, device=args.device)


if __name__ == "__main__":
    main()
