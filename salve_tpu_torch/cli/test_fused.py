"""CLI: fused Stage B+C inference — score hypotheses with zero image files.

Port of salve_tpu/cli/test_fused.py. Hypotheses are rendered and verified
on the card (pipeline/fused_inference.py) and only the Stage C->D
batch_{i}.json contract is written, with fp0/fp1 in the exact BEV filename
grammar Stage D parses back.

Checkpoints: a reference `train_ckpt.pth` (loaded natively, models/weights.py),
salve_tpu's `train_ckpt.flax` (training/flax_checkpoint.py), the port's
training checkpoint `train_ckpt.pt`, or a state_dict of the port's model saved
with `torch.save` (`.pt`). The
parser is the standard library's argparse (`main(argv)`), with the JAX
package's flags.
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import time
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from salve_tpu_torch.cli.args import existing_path

logger = logging.getLogger(__name__)


def _parse_hyp_fpath(fpath: str) -> Tuple[int, int, str, str]:
    """(i1, i2, wdo_pair_uuid, configuration) from a hypothesis JSON path.

    Grammar: `{i1}_{i2}__{wdo_pair_uuid}_{configuration}.json`.
    """
    stem = Path(fpath).stem
    pair_part, suffix = stem.split("__", 1)
    i1, i2 = (int(x) for x in pair_part.split("_"))
    uuid, configuration = suffix.rsplit("_", 1)
    return i1, i2, uuid, configuration


def _save_json_file(json_fpath: str, data) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(json_fpath)), exist_ok=True)
    with open(json_fpath, "w") as f:
        json.dump(data, f, indent=4)


def score_building_fused(
    building_id: str,
    hypotheses_save_root: str,
    raw_dataset_dir: str,
    depth_save_root: str,
    model,
    cfg,
    serialization_save_dir: str,
    batch_size: int = 32,
    start_batch_idx: int = 0,
    render_cfg=None,
    use_warp_renders=None,
    device=None,
) -> int:
    """Score every hypothesis of one building; write batch_{i}.json files.

    Returns the number of batch files written.
    """
    from salve_tpu_torch.common.alignment_hypothesis import AlignmentHypothesis
    from salve_tpu_torch.depth.cache import infer_depth_if_nonexistent
    from salve_tpu_torch.device import resolve_device
    from salve_tpu_torch.geometry.sim2 import Sim2
    from salve_tpu_torch.pipeline.fused_inference import score_floor_hypotheses
    from salve_tpu_torch.rendering import bev_pair

    dev = resolve_device(device)
    if render_cfg is None:
        render_cfg = bev_pair.BEVRenderConfig()

    img_fpaths = glob.glob(f"{raw_dataset_dir}/{building_id}/panos/*.jpg")
    img_fpaths_dict = {int(Path(fp).stem.split("_")[-1]): fp for fp in img_fpaths}

    n_written = 0
    floor_dirs = sorted(glob.glob(f"{hypotheses_save_root}/{building_id}/floor*"))
    for floor_dir in floor_dirs:
        floor_id = Path(floor_dir).name

        # pair_idx enumerates the sorted hypothesis files per label dir, as
        # the file-contract renderer does.
        hyps: List[Tuple[int, int, object]] = []
        meta: List[Tuple[str, str, int]] = []  # (fp0, fp1, y_true)
        needed = set()
        for label_type, y_true in (("gt_alignment_approx", 1), ("incorrect_alignment", 0)):
            pair_fpaths = sorted(glob.glob(f"{floor_dir}/{label_type}/*.json"))
            for pair_idx, pair_fpath in enumerate(pair_fpaths):
                i1, i2, uuid, configuration = _parse_hyp_fpath(pair_fpath)
                if i1 not in img_fpaths_dict or i2 not in img_fpaths_dict:
                    continue
                obj, i1_wdo_idx, i2_wdo_idx = uuid.split("_")
                hyps.append(
                    (
                        i1,
                        i2,
                        AlignmentHypothesis(
                            i2Ti1=Sim2.from_json(pair_fpath),
                            wdo_alignment_object=obj,
                            i1_wdo_idx=int(i1_wdo_idx),
                            i2_wdo_idx=int(i2_wdo_idx),
                            configuration=configuration,
                        ),
                    )
                )
                fname1 = bev_pair.bev_fname_from_img_fpath(
                    pair_idx, f"{uuid}_{configuration}", "floor", img_fpaths_dict[i1]
                )
                fname2 = bev_pair.bev_fname_from_img_fpath(
                    pair_idx, f"{uuid}_{configuration}", "floor", img_fpaths_dict[i2]
                )
                meta.append(
                    (f"{label_type}/{building_id}/{fname1}", f"{label_type}/{building_id}/{fname2}", y_true)
                )
                needed.update([i1, i2])
        if not hyps:
            continue

        pano_ids = sorted(needed)
        id2row = {pid: k for k, pid in enumerate(pano_ids)}
        depths = np.stack(
            [
                bev_pair.load_depth_mm(
                    infer_depth_if_nonexistent(depth_save_root, building_id, img_fpaths_dict[pid])
                )
                for pid in pano_ids
            ]
        )
        rgbs = np.stack(
            [bev_pair.load_pano_rgb(img_fpaths_dict[pid]) for pid in pano_ids]
        ).astype(np.float32)

        t0 = time.time()
        results = score_floor_hypotheses(
            model, cfg, depths, rgbs, id2row, hyps,
            batch_size=batch_size, render_cfg=render_cfg,
            use_warp_renders=use_warp_renders, device=dev,
        )
        elapsed = max(time.time() - t0, 1e-9)
        logger.info(
            "%s %s: scored %d hypotheses in %.1fs (%.1f hyp/s) on %s",
            building_id, floor_id, len(results), elapsed, len(results) / elapsed, dev,
        )

        for start in range(0, len(results), batch_size):
            rs = results[start : start + batch_size]
            ms = meta[start : start + batch_size]
            _save_json_file(
                f"{serialization_save_dir}/batch_{start_batch_idx + n_written}.json",
                {
                    "y_hat": [r.y_hat for r in rs],
                    "y_true": [m[2] for m in ms],
                    "y_hat_probs": [r.prob for r in rs],
                    "fp0": [m[0] for m in ms],
                    "fp1": [m[1] for m in ms],
                },
            )
            n_written += 1
    return n_written


def load_verifier(ckpt_fpath: str, cfg):
    """Build the verifier for `cfg` and load any checkpoint
    `models/weights.py:read_verifier_checkpoint` accepts."""
    from salve_tpu_torch.models.early_fusion import EarlyFusionCEResnet
    from salve_tpu_torch.models.weights import read_verifier_checkpoint

    model = EarlyFusionCEResnet(
        num_layers=cfg.num_layers,
        modalities=cfg.modalities,
        compute_dtype=cfg.compute_dtype,
        append_pair_difference=cfg.append_pair_difference,
    )
    model.load_state_dict(read_verifier_checkpoint(ckpt_fpath, cfg.num_layers)["model"], strict=True)
    return model


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Fused render+verify inference: hypotheses -> batch_{i}.json, no image files.")
    p.add_argument("--hypotheses_save_root", type=existing_path, required=True)
    p.add_argument("--raw_dataset_dir", type=existing_path, required=True)
    p.add_argument("--depth_save_root", type=str, required=True)
    p.add_argument("--ckpt_fpath", type=existing_path, required=True,
                   help="Reference train_ckpt.pth, salve_tpu's train_ckpt.flax, the port's train_ckpt.pt, "
                        "or a state_dict of the port's model (.pt).")
    p.add_argument("--serialization_save_dir", type=str, required=True)
    p.add_argument("--building_id", type=str, default=None,
                   help="Single building (default: every building with hypotheses).")
    p.add_argument("--num_layers", type=int, default=152)
    p.add_argument("--resize_px", type=int, default=234)
    p.add_argument("--crop_px", type=int, default=224)
    p.add_argument("--batch_size", type=int, default=32)
    warp = p.add_mutually_exclusive_group()
    warp.add_argument("--use_warp_renders", dest="use_warp_renders", action="store_true", default=None,
                      help="Render pano 1 per hypothesis as a Sim(2) warp of an extended identity bank "
                           "instead of a fresh splat. Default: on for CUDA, off on the CPU.")
    warp.add_argument("--no_warp_renders", dest="use_warp_renders", action="store_false", default=None)
    p.add_argument("--append_pair_difference", action="store_true",
                   help="Checkpoint was trained with explicit per-pair difference channels.")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu.")
    return p


def main(argv: Optional[List[str]] = None) -> None:
    run_test_fused(**vars(build_parser().parse_args(argv)))


def run_test_fused(
    hypotheses_save_root, raw_dataset_dir, depth_save_root, ckpt_fpath,
    serialization_save_dir, building_id, num_layers, resize_px, crop_px,
    batch_size, use_warp_renders, append_pair_difference, device,
) -> None:
    logging.basicConfig(level=logging.INFO)
    from salve_tpu_torch.training.config import TrainingConfig

    cfg = TrainingConfig(
        num_layers=num_layers,
        modalities=("ceiling_rgb_texture", "floor_rgb_texture"),
        resize_h=resize_px, resize_w=resize_px,
        train_h=crop_px, train_w=crop_px,
        batch_size=batch_size,
        append_pair_difference=append_pair_difference,
    )
    model = load_verifier(ckpt_fpath, cfg)

    Path(serialization_save_dir).mkdir(parents=True, exist_ok=True)
    if building_id is not None:
        building_ids = [building_id]
    else:
        building_ids = sorted(Path(p).name for p in glob.glob(f"{hypotheses_save_root}/*"))

    total = 0
    for bid in building_ids:
        total += score_building_fused(
            bid, hypotheses_save_root, raw_dataset_dir, depth_save_root,
            model, cfg, serialization_save_dir,
            batch_size=batch_size, start_batch_idx=total,
            use_warp_renders=use_warp_renders, device=device,
        )
    logger.info("wrote %d batch files to %s", total, serialization_save_dir)


if __name__ == "__main__":
    main()
