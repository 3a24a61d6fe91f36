"""CLI: run OpenSfM per building floor (parity: scripts/execute_opensfm.py).

OpenSfM is an external binary in the reference too; this CLI prepares
per-floor image directories, shells out, and collects reconstruction.json
outputs for evaluation with evaluate_sfm_baseline.

A copy of salve_tpu/cli/execute_opensfm.py (no JAX) on the standard
library's argparse, with the click original's flags; host code:

    python -m salve_tpu_torch.cli.execute_opensfm --raw_dataset_dir ZIND \\
        --opensfm_repo_root OPENSFM --output_dir OUT [--building_id ID]
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
from pathlib import Path
from typing import List, Optional

from salve_tpu_torch.cli.args import existing_path
from salve_tpu_torch.dataset.zind_partition import DATASET_SPLITS
from salve_tpu_torch.utils.subprocess_utils import run_command


def run_execute_opensfm(
    raw_dataset_dir: str,
    opensfm_repo_root: str,
    overrides_fpath: Optional[str],
    output_dir: str,
    split: str,
    building_id: Optional[str],
) -> None:
    building_ids = [building_id] if building_id else sorted(DATASET_SPLITS[split])
    for bid in building_ids:
        pano_fpaths = sorted(glob.glob(f"{raw_dataset_dir}/{bid}/panos/*.jpg"))
        floor_ids = sorted({Path(p).stem.split("_partial")[0] for p in pano_fpaths})
        for floor_id in floor_ids:
            floor_dir = f"{output_dir}/ZinD_{bid}_{floor_id}__opensfm"
            img_dir = f"{floor_dir}/images"
            os.makedirs(img_dir, exist_ok=True)
            for p in glob.glob(f"{raw_dataset_dir}/{bid}/panos/{floor_id}_*.jpg"):
                shutil.copy(p, img_dir)
            if overrides_fpath:
                shutil.copy(overrides_fpath, f"{floor_dir}/config.yaml")
            cmd = f"{opensfm_repo_root}/bin/opensfm_run_all {floor_dir}"
            print(f"Running: {cmd}")
            run_command(cmd)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Run OpenSfM on ZInD buildings (requires external OpenSfM install).")
    p.add_argument("--raw_dataset_dir", type=existing_path, required=True)
    p.add_argument("--opensfm_repo_root", type=existing_path, required=True,
                   help="Path to cloned OpenSfM repo (bin/opensfm_run_all).")
    p.add_argument("--overrides_fpath", type=existing_path, default=None,
                   help="Path to a config.yaml with spherical-camera overrides.")
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--split", choices=["train", "val", "test"], default="test")
    p.add_argument("--building_id", type=str, default=None)
    return p


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    run_execute_opensfm(args.raw_dataset_dir, args.opensfm_repo_root, args.overrides_fpath, args.output_dir,
                        args.split, args.building_id)


if __name__ == "__main__":
    main()
