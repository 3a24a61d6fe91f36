"""CLI: capture-order adjacency histograms (parity: scripts/analyze_capture_order.py).

A copy of salve_tpu/cli/analyze_capture_order.py (no JAX) on the standard
library's argparse, with the click original's flags; host code. The
histogram is the product: without matplotlib it raises
`plotting.MatplotlibMissing` before it reads or writes anything.

    python -m salve_tpu_torch.cli.analyze_capture_order --hypotheses_save_root HYPS
"""

from __future__ import annotations

import argparse
import glob
from collections import defaultdict
from pathlib import Path
from typing import List, Optional

import numpy as np

from salve_tpu_torch.cli.args import existing_path
from salve_tpu_torch.utils import plotting


def run_analyze_capture_order(hypotheses_save_root: str, save_fpath: str = "capture_order_histogram.png") -> None:
    """Histogram the capture-order distance |i - j| of every hypothesis, per label type."""
    plotting.require("analyze_capture_order")
    traj_distance_dict = defaultdict(list)
    building_ids = sorted(
        Path(p).stem for p in glob.glob(f"{hypotheses_save_root}/*") if Path(p).is_dir()
    )
    for building_id in building_ids:
        for floor_dir in glob.glob(f"{hypotheses_save_root}/{building_id}/*"):
            for label_type in ["gt_alignment_approx", "gt_alignment_exact", "incorrect_alignment"]:
                for json_fpath in glob.glob(f"{floor_dir}/{label_type}/*.json"):
                    i, j = (int(x) for x in Path(json_fpath).stem.split("_")[:2])
                    traj_distance_dict[label_type].append(abs(i - j))

    plt = plotting.pyplot("analyze_capture_order")

    fig, axes = plt.subplots(1, max(len(traj_distance_dict), 1), figsize=(12, 4))
    if len(traj_distance_dict) == 1:
        axes = [axes]
    for ax, (label_type, dists) in zip(np.atleast_1d(axes), traj_distance_dict.items()):
        ax.hist(dists, bins=np.arange(0, 30))
        ax.set_title(label_type)
        ax.set_xlabel("|i - j| capture distance")
        print(f"{label_type}: mean |i-j| = {np.mean(dists):.2f} over {len(dists)} pairs")
    plt.tight_layout()
    plt.savefig(save_fpath, dpi=200)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Histogram temporal (capture-order) distance per hypothesis label type.")
    p.add_argument("--hypotheses_save_root", type=existing_path, required=True)
    p.add_argument("--save_fpath", type=str, default="capture_order_histogram.png")
    return p


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    run_analyze_capture_order(args.hypotheses_save_root, args.save_fpath)


if __name__ == "__main__":
    main()
