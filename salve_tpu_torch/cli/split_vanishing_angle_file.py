"""CLI: split a monolithic vanishing-angle CSV into per-building JSONs
(parity: scripts/split_vanishing_angle_file.py).

A copy of salve_tpu/cli/split_vanishing_angle_file.py (no JAX) on the
standard library's argparse, with the click original's flags; host code:

    python -m salve_tpu_torch.cli.split_vanishing_angle_file --csv ANGLES.csv --out_dir OUT
"""

from __future__ import annotations

import argparse
import csv
import json
import os
from typing import List, Optional

from salve_tpu_torch.cli.args import existing_path


def split_vanishing_angles(csv_path: str, out_dir: str) -> int:
    os.makedirs(out_dir, exist_ok=True)
    vanishing_angles = {}
    with open(csv_path, "r") as csv_file:
        for i_row, row in enumerate(csv.reader(csv_file, delimiter=",")):
            if i_row == 0:
                continue
            i_building, pano_id, degree = row
            building_id = "%04d" % int(i_building)
            pano_id = pano_id.split(".")[0]
            vanishing_angles.setdefault(building_id, {})[pano_id] = float(degree)

    for building_id, vps in vanishing_angles.items():
        with open(os.path.join(out_dir, f"{building_id}.json"), "w") as f:
            json.dump(vps, f)
    return len(vanishing_angles)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Split a vanishing-angle CSV into per-building JSON files.")
    p.add_argument("--csv", dest="csv_path", type=existing_path, required=True)
    p.add_argument("--out_dir", type=str, required=True)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    n = split_vanishing_angles(args.csv_path, args.out_dir)
    print(f"Vanishing angle extraction complete ({n} buildings).")
    return n


if __name__ == "__main__":
    main()
