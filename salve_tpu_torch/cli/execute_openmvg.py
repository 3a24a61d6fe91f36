"""CLI: run OpenMVG per building floor (parity: scripts/execute_openmvg.py).

A copy of salve_tpu/cli/execute_openmvg.py (no JAX) on the standard
library's argparse, with the click original's flags; host code:

    python -m salve_tpu_torch.cli.execute_openmvg --raw_dataset_dir ZIND \\
        --openmvg_sfm_bin OPENMVG/bin --output_dir OUT [--building_id ID]
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
from pathlib import Path
from typing import List, Optional

from salve_tpu_torch.baselines.openmvg import find_seed_pair
from salve_tpu_torch.cli.args import existing_path
from salve_tpu_torch.dataset.zind_partition import DATASET_SPLITS
from salve_tpu_torch.utils.subprocess_utils import run_command


def run_execute_openmvg(
    raw_dataset_dir: str, openmvg_sfm_bin: str, output_dir: str, split: str, building_id: Optional[str]
) -> None:
    building_ids = [building_id] if building_id else sorted(DATASET_SPLITS[split])
    for bid in building_ids:
        pano_fpaths = sorted(glob.glob(f"{raw_dataset_dir}/{bid}/panos/*.jpg"))
        floor_ids = sorted({Path(p).stem.split("_partial")[0] for p in pano_fpaths})
        for floor_id in floor_ids:
            floor_dir = f"{output_dir}/ZinD_{bid}_{floor_id}__openmvg"
            img_dir = f"{floor_dir}/images"
            matches_dir = f"{floor_dir}/matches"
            recon_dir = f"{floor_dir}/reconstruction"
            for d in (img_dir, matches_dir, recon_dir):
                os.makedirs(d, exist_ok=True)
            for p in glob.glob(f"{raw_dataset_dir}/{bid}/panos/{floor_id}_*.jpg"):
                shutil.copy(p, img_dir)
            try:
                seed1, seed2 = find_seed_pair(img_dir)
            except (ValueError, IndexError):
                print(f"No seed pair for {bid} {floor_id}, skipping.")
                continue
            cmds = [
                f"{openmvg_sfm_bin}/openMVG_main_SfMInit_ImageListing -i {img_dir}"
                f" -o {matches_dir} -c 7 -f 1",  # camera model 7 = spherical
                f"{openmvg_sfm_bin}/openMVG_main_ComputeFeatures"
                f" -i {matches_dir}/sfm_data.json -o {matches_dir} -m SIFT",
                f"{openmvg_sfm_bin}/openMVG_main_ComputeMatches"
                f" -i {matches_dir}/sfm_data.json -o {matches_dir}/matches.putative.bin",
                f"{openmvg_sfm_bin}/openMVG_main_GeometricFilter"
                f" -i {matches_dir}/sfm_data.json -m {matches_dir}/matches.putative.bin"
                f" -g a -o {matches_dir}/matches.f.bin",
                f"{openmvg_sfm_bin}/openMVG_main_IncrementalSfM"
                f" -i {matches_dir}/sfm_data.json -m {matches_dir} -o {recon_dir}"
                f" -a {seed1} -b {seed2}",
                f"{openmvg_sfm_bin}/openMVG_main_ConvertSfM_DataFormat"
                f" -i {recon_dir}/sfm_data.bin -o {recon_dir}/sfm_data.json",
            ]
            for cmd in cmds:
                print(f"Running: {cmd}")
                run_command(cmd)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Run OpenMVG spherical SfM on ZInD buildings (requires external OpenMVG install).")
    p.add_argument("--raw_dataset_dir", type=existing_path, required=True)
    p.add_argument("--openmvg_sfm_bin", type=existing_path, required=True, help="Path to OpenMVG build bin directory.")
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--split", choices=["train", "val", "test"], default="test")
    p.add_argument("--building_id", type=str, default=None)
    return p


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    run_execute_openmvg(args.raw_dataset_dir, args.openmvg_sfm_bin, args.output_dir, args.split, args.building_id)


if __name__ == "__main__":
    main()
