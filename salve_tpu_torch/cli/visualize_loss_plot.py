"""CLI: plot train/val loss and accuracy curves (parity: scripts/visualize_loss_plot.py).

A copy of salve_tpu/cli/visualize_loss_plot.py (no JAX) on the standard
library's argparse, with the click original's flags; host code. The plot is
the product: without matplotlib it raises `plotting.MatplotlibMissing`
before it reads or writes anything.

    python -m salve_tpu_torch.cli.visualize_loss_plot --train_results_fpath RUN/results.json
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Optional

from salve_tpu_torch.cli.args import existing_path
from salve_tpu_torch.utils import plotting
from salve_tpu_torch.utils.io import read_json_file


def plot_metrics(json_fpath: str, save_fpath: str = None, show: bool = False) -> None:
    """Train/val loss + mAcc vs epoch from a results JSON."""
    plt = plotting.pyplot("plot_metrics", agg=not show)

    json_data = read_json_file(json_fpath)
    fig = plt.figure(dpi=200, facecolor="white", figsize=(10, 4))
    color_dict = {"train": "r", "val": "g"}

    for i, metric_name in enumerate(["avg_loss", "mAcc"]):
        fig.add_subplot(1, 2, i + 1)
        for split in ["train", "val"]:
            key = f"{split}_{metric_name}"
            if key not in json_data:
                continue
            vals = json_data[key]
            plt.plot(range(len(vals)), vals, color_dict[split], label=split)
        plt.ylabel(metric_name)
        plt.xlabel("epoch")
        plt.legend(loc="lower right")

    if save_fpath is None:
        save_fpath = str(Path(json_fpath).with_suffix(".png"))
    plt.tight_layout()
    plt.savefig(save_fpath, dpi=200)
    if show:
        plt.show()
    plt.close("all")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Visualize loss plot, given training logs.")
    p.add_argument("--train_results_fpath", type=existing_path, required=True,
                   help="Path to results JSON written by the training loop.")
    p.add_argument("--save_fpath", type=str, default=None)
    return p


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    plotting.require("visualize_loss_plot")
    plot_metrics(args.train_results_fpath, args.save_fpath)


if __name__ == "__main__":
    main()
