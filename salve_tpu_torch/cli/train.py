"""CLI: train the early-fusion verifier (port of salve_tpu/cli/train.py).

Takes the same options as the click original, on argparse, plus
`--device` (default cuda; the CPU only when asked). The YAML config is
read by the port's own reader (training/config.py). A config whose
`mesh_shape` asks for N > 1 processes trains data-parallel over N cards:
run alone, the CLI starts the N ranks (parallel/mesh.py:launch; gloo ranks
on the CPU with `--device cpu`); inside a process group of N (torchrun) it
joins it.

    python -m salve_tpu_torch.cli.train --config_fpath salve_tpu_torch/configs/ceiling_floor_rgb.yaml \\
        --data_root BEV_ROOT --model_save_dirpath OUT
"""

from __future__ import annotations

import argparse
import logging
import math
from typing import List, Optional

from salve_tpu_torch.cli.args import existing_path
from salve_tpu_torch.device import set_cublas_workspace_config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train the SALVe early-fusion verifier on rendered BEV pairs.")
    p.add_argument("--config_fpath", type=existing_path, default=None,
                   help="Path to a TrainingConfig YAML (reference hydra format).")
    p.add_argument("--data_root", type=str, default=None, help="Rendered BEV texture-map root.")
    p.add_argument("--layout_data_root", type=str, default=None, help="Rendered layout root.")
    p.add_argument("--model_save_dirpath", type=str, default=None, help="Checkpoint output dir.")
    p.add_argument("--num_epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--num_layers", type=int, default=None, help="ResNet depth (18/34/50/152).")
    p.add_argument("--max_batches_per_epoch", type=int, default=None, help="Debug cap.")
    p.add_argument("--resume_from", type=existing_path, default=None,
                   help="Checkpoint (the port's .pt, salve_tpu's .flax, or a reference .pth) to resume from.")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu.")
    return p


def main(argv: Optional[List[str]] = None) -> None:
    set_cublas_workspace_config()
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from salve_tpu_torch.training.config import TrainingConfig, load_training_config
    from salve_tpu_torch.training.loop import train

    cfg = load_training_config(args.config_fpath) if args.config_fpath else TrainingConfig()
    for name in ("data_root", "layout_data_root", "model_save_dirpath", "num_epochs", "batch_size", "num_layers"):
        val = getattr(args, name)
        if val is not None:
            setattr(cfg, name, val)
    kwargs = dict(max_batches_per_epoch=args.max_batches_per_epoch, resume_from=args.resume_from, device=args.device)
    n = math.prod(cfg.mesh_shape) if cfg.mesh_shape is not None else 1
    if n > 1:
        import torch
        import torch.distributed as dist

        from salve_tpu_torch.device import resolve_device
        from salve_tpu_torch.parallel.mesh import launch

        if not dist.is_initialized():
            dev = resolve_device(args.device)
            if dev.type == "cuda" and torch.cuda.device_count() < n:
                raise ValueError(f"mesh_shape {tuple(cfg.mesh_shape)} but only {torch.cuda.device_count()} CUDA "
                                 "card(s) visible")
            launch(_train_rank, n, cfg, kwargs, device=dev)
            return
    train(cfg, **kwargs)


def _train_rank(cfg, kwargs: dict) -> None:
    from salve_tpu_torch.training.loop import train

    train(cfg, **kwargs)


if __name__ == "__main__":
    main()
