"""CLI: side-by-side floorplans for baseline SfM results
(parity: scripts/visualize_floorplans_side_by_side_baselines.py).

A copy of salve_tpu/cli/visualize_floorplans_side_by_side_baselines.py (no
JAX) on the standard library's argparse, with the click original's flags
plus `--device`: each floor's RANSAC Sim(3) alignment and report run there
(`baselines/sfm_eval.py`), on the CUDA card by default, raising without one.
The report draws the side-by-side floorplans as a side product; here they
are the product: without matplotlib the CLI raises
`plotting.MatplotlibMissing` before it reads or writes anything.
`baseline_floor_reports` is the computation alone.

    python -m salve_tpu_torch.cli.visualize_floorplans_side_by_side_baselines --raw_dataset_dir ZIND \\
        --results_dir RESULTS --algorithm_name opensfm --save_dir OUT [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
from pathlib import Path
from typing import List, Optional

from salve_tpu_torch.baselines.sfm_eval import measure_algorithm_localization_accuracy
from salve_tpu_torch.cli.args import existing_path
from salve_tpu_torch.device import DeviceLike, resolve_device
from salve_tpu_torch.utils import plotting


def baseline_floor_reports(
    raw_dataset_dir: str, results_dir: str, algorithm_name: str, save_dir: str, device: DeviceLike = None
) -> list:
    """The report of every ZinD_{building}_{floor}__{algorithm_name} floor
    under `results_dir`, on `device` (None: the card); each report draws its
    figures where matplotlib is installed (`utils/plotting.py`, rule (b))."""
    dev = resolve_device(device)
    reports = []
    for floor_dir in sorted(glob.glob(f"{results_dir}/ZinD_*__{algorithm_name}")):
        stem = Path(floor_dir).name
        parts = stem.split("__")[0].split("_")
        building_id, floor_id = parts[1], "_".join(parts[2:])
        recon_fpath = (
            f"{floor_dir}/reconstruction.json"
            if algorithm_name == "opensfm"
            else f"{floor_dir}/reconstruction/sfm_data.json"
        )
        reports.append(measure_algorithm_localization_accuracy(
            building_id, floor_id, raw_dataset_dir, algorithm_name, save_dir, recon_fpath, device=dev
        ))
        print(f"Rendered {building_id} {floor_id}")
    return reports


def run_visualize_floorplans_side_by_side_baselines(
    raw_dataset_dir: str, results_dir: str, algorithm_name: str, save_dir: str, device: DeviceLike = None
) -> list:
    """Render side-by-side floorplans of every baseline floor; returns the reports."""
    plotting.require("visualize_floorplans_side_by_side_baselines")
    return baseline_floor_reports(raw_dataset_dir, results_dir, algorithm_name, save_dir, device)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Render side-by-side floorplans for OpenSfM/OpenMVG results.")
    p.add_argument("--raw_dataset_dir", type=existing_path, required=True)
    p.add_argument("--results_dir", type=existing_path, required=True)
    p.add_argument("--algorithm_name", choices=["opensfm", "openmvg"], required=True)
    p.add_argument("--save_dir", type=str, required=True)
    p.add_argument("--device", type=str, default="cuda",
                   help="Where the alignment and the reports run ('cuda' or 'cpu'; default: cuda).")
    return p


def main(argv: Optional[List[str]] = None) -> list:
    args = build_parser().parse_args(argv)
    return run_visualize_floorplans_side_by_side_baselines(args.raw_dataset_dir, args.results_dir,
                                                           args.algorithm_name, args.save_dir, device=args.device)


if __name__ == "__main__":
    main()
