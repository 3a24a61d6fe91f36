"""CLI: precision-recall curves for verifier models (parity: scripts/make_precision_recall_plots.py).

A copy of salve_tpu/cli/make_precision_recall_plots.py (no JAX) on the
standard library's argparse, with the click original's flags (each
repeated flag once per model); host code. The plot is the product: without
matplotlib it raises `plotting.MatplotlibMissing` before it reads or writes
anything.

    python -m salve_tpu_torch.cli.make_precision_recall_plots \\
        --serialized_preds_json_dir PREDS_A --model_name a --serialized_preds_json_dir PREDS_B --model_name b
"""

from __future__ import annotations

import argparse
import glob
from typing import Dict, List, Optional

import numpy as np

from salve_tpu_torch.cli.args import existing_path
from salve_tpu_torch.utils import plotting
from salve_tpu_torch.utils.io import read_json_file
from salve_tpu_torch.utils.pr_utils import plot_precision_recall_curve_sklearn


def _collect_scores(serialized_preds_json_dir: str):
    """(y_true, positive-class score) for every serialized prediction."""
    y_true, y_score = [], []
    for fpath in glob.glob(f"{serialized_preds_json_dir}/batch*.json"):
        data = read_json_file(fpath)
        for yt, yh, prob in zip(data["y_true"], data["y_hat"], data["y_hat_probs"]):
            y_true.append(yt)
            # y_hat_probs is the probability of the predicted class; convert
            # to the positive-class probability.
            y_score.append(prob if yh == 1 else 1.0 - prob)
    return np.array(y_true), np.array(y_score)


def compare_precision_recall_across_models(
    model_dict: Dict[str, str], save_fpath: str = "precision_recall.pdf"
) -> None:
    """One PR curve per trained model on a shared plot."""
    plt = plotting.pyplot("compare_precision_recall_across_models")

    plt.style.use("ggplot")
    for model_name, preds_dir in model_dict.items():
        y_true, y_score = _collect_scores(preds_dir)
        prec, rec, _ = plot_precision_recall_curve_sklearn(y_true, y_score)
        plt.plot(rec, prec, label=model_name)

    plt.legend(fontsize="x-large")
    plt.xlabel("Recall")
    plt.ylabel("Precision")
    plt.tight_layout()
    plt.savefig(save_fpath, dpi=500)
    plt.close("all")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Make precision-recall curves for verifier predictions.")
    p.add_argument("--serialized_preds_json_dir", type=existing_path, action="append", required=True)
    p.add_argument("--model_name", type=str, action="append", required=True)
    p.add_argument("--save_fpath", type=str, default="precision_recall.pdf")
    return p


def main(argv: Optional[List[str]] = None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    if len(args.serialized_preds_json_dir) != len(args.model_name):
        parser.error("Provide one --model_name per --serialized_preds_json_dir.")
    plotting.require("make_precision_recall_plots")
    compare_precision_recall_across_models(
        dict(zip(args.model_name, args.serialized_preds_json_dir)), args.save_fpath
    )


if __name__ == "__main__":
    main()
