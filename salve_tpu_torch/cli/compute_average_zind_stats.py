"""CLI: corpus statistics over ZInD (parity: scripts/compute_average_zind_stats.py).

A copy of salve_tpu/cli/compute_average_zind_stats.py (no JAX) on the
standard library's argparse, with the click original's flag; host code:

    python -m salve_tpu_torch.cli.compute_average_zind_stats --raw_dataset_dir ZIND
"""

from __future__ import annotations

import argparse
import glob
from pathlib import Path
from typing import List, Optional

import numpy as np

from salve_tpu_torch.cli.args import existing_path
from salve_tpu_torch.common import posegraph2d


def run_compute_average_zind_stats(raw_dataset_dir: str) -> None:
    building_ids = sorted(
        Path(p).stem for p in glob.glob(f"{raw_dataset_dir}/*") if Path(p).is_dir()
    )
    num_floors, num_panos, scales = [], [], []
    for building_id in building_ids:
        try:
            floor_ids = posegraph2d.compute_available_floors_for_building(
                building_id, raw_dataset_dir
            )
        except (FileNotFoundError, KeyError):
            continue
        num_floors.append(len(floor_ids))
        for floor_id in floor_ids:
            pg = posegraph2d.get_gt_pose_graph(building_id, floor_id, raw_dataset_dir)
            num_panos.append(len(pg.nodes))
            scales.append(pg.scale_meters_per_coordinate)

    print(f"Buildings: {len(num_floors)}")
    print(f"Avg floors/building: {np.mean(num_floors):.2f}")
    print(f"Avg panos/floor: {np.mean(num_panos):.2f}")
    print(f"Avg scale (m/coord): {np.mean(scales):.4f}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Compute average #panos/#floors/scale statistics over ZInD.")
    p.add_argument("--raw_dataset_dir", type=existing_path, required=True)
    return p


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    run_compute_average_zind_stats(args.raw_dataset_dir)


if __name__ == "__main__":
    main()
