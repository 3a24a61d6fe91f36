"""CLI: verifier inference over a split (port of salve_tpu/cli/test.py).

Writes per-batch prediction JSONs (batch_{i}.json with y_hat / y_true /
y_hat_probs / fp0 / fp1), the Stage C -> Stage D interface, and prints
`precision=... recall=... mAcc=...`. The click original's options on
argparse, plus `--device` (default cuda).

    python -m salve_tpu_torch.cli.test --config_fpath salve_tpu_torch/configs/ceiling_floor_rgb.yaml \\
        --ckpt_fpath OUT/<run>/train_ckpt.pt --data_root BEV_ROOT --split test --serialization_save_dir PREDS
"""

from __future__ import annotations

import argparse
import logging
from typing import List, Optional

from salve_tpu_torch.cli.args import existing_path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Run verifier inference over a ZInD split and serialize predictions.")
    p.add_argument("--config_fpath", type=existing_path, default=None,
                   help="Path to a TrainingConfig YAML (reference hydra format).")
    p.add_argument("--ckpt_fpath", type=existing_path, required=True,
                   help="The port's train_ckpt.pt, salve_tpu's train_ckpt.flax, or a reference .pth.")
    p.add_argument("--data_root", type=str, default=None, help="Rendered BEV texture-map root.")
    p.add_argument("--split", choices=["train", "val", "test"], default="test")
    p.add_argument("--serialization_save_dir", type=str, required=True,
                   help="Directory for per-batch prediction JSONs.")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--max_batches", type=int, default=None, help="Debug cap.")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu.")
    return p


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from salve_tpu_torch.training.config import TrainingConfig, load_training_config
    from salve_tpu_torch.training.loop import evaluate

    cfg = load_training_config(args.config_fpath) if args.config_fpath else TrainingConfig()
    if args.data_root is not None:
        cfg.data_root = args.data_root
    if args.batch_size is not None:
        cfg.batch_size = args.batch_size
    prec, rec, mAcc = evaluate(cfg, args.ckpt_fpath, args.split, args.serialization_save_dir,
                               max_batches=args.max_batches, device=args.device)
    print(f"precision={prec:.4f} recall={rec:.4f} mAcc={mAcc:.4f}")


if __name__ == "__main__":
    main()
