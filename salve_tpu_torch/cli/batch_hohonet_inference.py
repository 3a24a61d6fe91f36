"""CLI: precompute depth maps for every pano (port of
salve_tpu/cli/batch_hohonet_inference.py).

The same options as the click original, on argparse, plus `--device`
(default cuda; the CPU only when asked). Panos stream through the depth
model on the device, one at a time, into the u16 mm PNG cache
(depth/cache.py). --model_ckpt is a HoHoNet `.pth` (built for
--hohonet_input_hw) or a trained PanoDepthNet checkpoint (the port's `.pt`
or salve_tpu's flax msgpack); without one, cached panos are counted and
missing ones reported.

    python -m salve_tpu_torch.cli.batch_hohonet_inference --raw_dataset_dir ZIND \\
        --depth_save_root DEPTH --building_id 0000 --model_ckpt ep60.pth [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import logging
from pathlib import Path
from typing import List, Optional

from salve_tpu_torch.cli.args import existing_path

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Precompute (or verify) monocular depth maps for ZInD panos.")
    p.add_argument("--raw_dataset_dir", type=existing_path, required=True)
    p.add_argument("--depth_save_root", type=str, required=True)
    p.add_argument("--split", choices=["train", "val", "test"], default=None)
    p.add_argument("--building_id", type=str, default=None)
    p.add_argument("--num_processes", type=int, default=1, help="Accepted for flag parity.")
    p.add_argument("--model_ckpt", type=existing_path, default=None,
                   help="HoHoNet .pth, or a trained PanoDepthNet checkpoint, to produce missing depth maps.")
    p.add_argument("--model_num_layers", type=int, default=50)
    p.add_argument("--hohonet_input_hw", type=str, default="512,1024",
                   help="Input resolution a .pth HoHoNet checkpoint was built for (the height compression bakes "
                        "the height into weight shapes); ep60 is the production 512,1024.")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu.")
    return p


def run_batch_hohonet_inference(args: argparse.Namespace) -> tuple:
    """Fill the cache for the buildings the options name; returns (ready, missing).
    The producer is registered for this run only."""
    from salve_tpu_torch.dataset.zind_partition import DATASET_SPLITS
    from salve_tpu_torch.depth import cache
    from salve_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    producer = None
    if args.model_ckpt:
        if args.model_ckpt.endswith(".pth"):
            from salve_tpu_torch.models.hohonet import load_hohonet_depth_provider

            hw = tuple(int(v) for v in args.hohonet_input_hw.split(","))
            producer = load_hohonet_depth_provider(args.model_ckpt, hw, device=device)
        else:
            from salve_tpu_torch.models.depth_net import load_depth_provider

            producer = load_depth_provider(args.model_ckpt, args.model_num_layers, device=device)
    building_ids = [args.building_id] if args.building_id else sorted(DATASET_SPLITS[args.split])

    previous = cache._DEPTH_MODEL
    cache.register_depth_model(producer)
    num_ok, num_missing = 0, 0
    try:
        for bid in building_ids:
            for img_fpath in sorted(glob.glob(f"{args.raw_dataset_dir}/{bid}/panos/*.jpg")):
                try:
                    cache.infer_depth_if_nonexistent(args.depth_save_root, bid, img_fpath)
                    num_ok += 1
                except FileNotFoundError:
                    logger.warning("No depth model registered and no cache for %s", Path(img_fpath).name)
                    num_missing += 1
    finally:
        cache.register_depth_model(previous)
    print(f"Depth maps ready: {num_ok}, missing: {num_missing}", flush=True)
    return num_ok, num_missing


def main(argv: Optional[List[str]] = None) -> tuple:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    return run_batch_hohonet_inference(args)


if __name__ == "__main__":
    main()
