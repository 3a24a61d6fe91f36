"""CLI: train the pano depth network on layout-raycast supervision (port of
salve_tpu/cli/train_depth.py).

The same options as the click original, on argparse, plus `--device`
(default cuda; the CPU only when asked). With --synthetic_rgb the imagery
is ray-cast from the GT layouts too (rendering/synthetic.py), so the net
trains and is measured without pano JPEGs. Writes the port's checkpoint
(`training/depth.py:save_depth_checkpoint`) to --model_save_fpath after
each epoch, and with --eval_buildings the depth metrics to
`<model_save_fpath>.eval.json`.

    python -m salve_tpu_torch.cli.train_depth --raw_dataset_dir ZIND \\
        --model_save_fpath OUT/depth.pt --synthetic_rgb --train_buildings 0000,0001 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import List, Optional

from salve_tpu_torch.cli.args import existing_path
from salve_tpu_torch.device import set_cublas_workspace_config

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train the monocular pano depth network (HoHoNet role).")
    p.add_argument("--raw_dataset_dir", type=existing_path, required=True)
    p.add_argument("--model_save_fpath", type=str, required=True)
    p.add_argument("--num_layers", type=int, default=50)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--num_epochs", type=int, default=10)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--max_steps", type=int, default=None, help="Debug cap.")
    p.add_argument("--synthetic_rgb", action="store_true",
                   help="Ray-cast imagery from GT layouts instead of reading pano JPGs.")
    p.add_argument("--train_buildings", type=str, default=None,
                   help="Comma-separated building IDs (default: official train split).")
    p.add_argument("--eval_buildings", type=str, default=None,
                   help="Comma-separated held-out building IDs to report depth metrics on.")
    p.add_argument("--pano_h", type=int, default=512)
    p.add_argument("--pano_w", type=int, default=1024)
    p.add_argument("--depth_cache_root", type=existing_path, default=None,
                   help="u16-mm depth cache dir: use cached depth as GT instead of the single-room layout "
                        "raycast (implies reading pano JPEGs from disk).")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu.")
    return p


def run_train_depth(args: argparse.Namespace) -> dict:
    """Train as the options say; returns {"train_steps", "losses", "eval"}."""
    import torch

    from salve_tpu_torch.dataset.zind_partition import DATASET_SPLITS
    from salve_tpu_torch.device import resolve_device
    from salve_tpu_torch.models.depth_net import make_depth_provider
    from salve_tpu_torch.training import depth as depth_train

    device = resolve_device(args.device)
    hw = (args.pano_h, args.pano_w)
    building_ids = sorted(args.train_buildings.split(",")) if args.train_buildings else sorted(DATASET_SPLITS["train"])
    state = depth_train.create_depth_train_state(torch.Generator().manual_seed(0), num_layers=args.num_layers,
                                                 learning_rate=args.learning_rate, input_hw=hw, device=device)
    step = depth_train.make_depth_train_step()
    os.makedirs(os.path.dirname(os.path.abspath(args.model_save_fpath)), exist_ok=True)

    losses = []
    done = False
    for epoch in range(args.num_epochs):
        for rgb, depth_gt, valid in depth_train.iter_layout_depth_batches(
            args.raw_dataset_dir, building_ids, args.batch_size, seed=epoch, synthetic_rgb=args.synthetic_rgb,
            hw=hw, cache_variants=3 if args.synthetic_rgb else 0, depth_cache_root=args.depth_cache_root,
        ):
            state, loss = step(state, rgb, depth_gt, valid)
            losses.append(loss)
            if len(losses) % 20 == 0:
                logger.info("epoch %d step %d loss %.4f", epoch, len(losses), float(loss))
            if args.max_steps is not None and len(losses) >= args.max_steps:
                done = True
                break
        depth_train.save_depth_checkpoint(args.model_save_fpath, state)
        logger.info("Saved checkpoint after epoch %d to %s", epoch, args.model_save_fpath)
        if done:
            break

    out = {"train_steps": len(losses), "losses": [float(v) for v in losses], "eval": None}
    if args.eval_buildings:
        metrics = depth_train.evaluate_depth(
            make_depth_provider(state.model), args.raw_dataset_dir, sorted(args.eval_buildings.split(",")),
            synthetic_rgb=args.synthetic_rgb, hw=hw, depth_cache_root=args.depth_cache_root,
        )
        metrics["train_steps"] = len(losses)
        print(json.dumps({"depth_eval": metrics}), flush=True)
        with open(args.model_save_fpath + ".eval.json", "w") as f:
            json.dump(metrics, f, indent=2)
        out["eval"] = metrics
    return out


def main(argv: Optional[List[str]] = None) -> dict:
    set_cublas_workspace_config()
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    return run_train_depth(args)


if __name__ == "__main__":
    main()
