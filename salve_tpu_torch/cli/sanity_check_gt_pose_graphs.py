"""CLI: validate all GT pose graphs load cleanly (parity: scripts/sanity_check_gt_pose_graphs.py).

A copy of salve_tpu/cli/sanity_check_gt_pose_graphs.py (no JAX) on the
standard library's argparse, with the click original's flag; host code:

    python -m salve_tpu_torch.cli.sanity_check_gt_pose_graphs --raw_dataset_dir ZIND
"""

from __future__ import annotations

import argparse
import glob
from pathlib import Path
from typing import List, Optional

from salve_tpu_torch.cli.args import existing_path
from salve_tpu_torch.common import posegraph2d


def run_sanity_check_dataset_pose_graphs(raw_dataset_dir: str) -> None:
    building_ids = sorted(
        Path(p).stem for p in glob.glob(f"{raw_dataset_dir}/*") if Path(p).is_dir()
    )
    num_ok, num_failed = 0, 0
    for building_id in building_ids:
        try:
            floor_ids = posegraph2d.compute_available_floors_for_building(
                building_id, raw_dataset_dir
            )
            for floor_id in floor_ids:
                pg = posegraph2d.get_gt_pose_graph(building_id, floor_id, raw_dataset_dir)
                if len(pg.nodes) == 0:
                    raise ValueError(f"floor {floor_id} has no panos")
            num_ok += 1
        except Exception as e:  # noqa: BLE001 - report-everything sanity sweep
            print(f"FAILED {building_id}: {e}")
            num_failed += 1
    print(f"{num_ok} buildings OK, {num_failed} failed.")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Sanity-check that every building's GT pose graphs parse.")
    p.add_argument("--raw_dataset_dir", type=existing_path, required=True)
    return p


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    run_sanity_check_dataset_pose_graphs(args.raw_dataset_dir)


if __name__ == "__main__":
    main()
