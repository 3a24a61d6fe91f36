"""CLI: query texture-map rendering progress (parity: scripts/estimate_completion_percent.py).

A copy of salve_tpu/cli/estimate_completion_percent.py (no JAX) on the
standard library's argparse, with the click original's flags; host code:

    python -m salve_tpu_torch.cli.estimate_completion_percent --hypotheses_save_root HYPS \\
        --bev_save_root BEV
"""

from __future__ import annotations

import argparse
import glob
from pathlib import Path
from typing import List, Optional

from salve_tpu_torch.cli.args import existing_path

EPS = 1e-10


def query_completion_progress(hypotheses_save_root: str, bev_save_root: str) -> None:
    """Per-building rendering completion percent (4 files per hypothesis)."""
    building_ids = sorted(
        Path(d).name for d in glob.glob(f"{bev_save_root}/gt_alignment_approx/*")
    )
    for building_id in building_ids:
        for label, key in [("Pos.", "gt_alignment_approx"), ("Neg.", "incorrect_alignment")]:
            hyp_glob = f"{hypotheses_save_root}/{building_id}/*/{key}/*"
            render_glob = f"{bev_save_root}/{key}/{building_id}/*"
            num_rendered = len(glob.glob(render_glob)) / 4
            expected = len(glob.glob(hyp_glob))
            pct = num_rendered / (expected + EPS) * 100
            # The positives and negatives of a building share one line.
            print(f"Building {building_id} {label} {pct:.2f}%", end="\n" if label == "Neg." else "")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Query completion progress of texture-map rendering during execution.")
    p.add_argument("--hypotheses_save_root", type=existing_path, required=True)
    p.add_argument("--bev_save_root", type=existing_path, required=True)
    return p


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    query_completion_progress(args.hypotheses_save_root, args.bev_save_root)


if __name__ == "__main__":
    main()
