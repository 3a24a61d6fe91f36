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

`--mesh_devices N` shards every batch over N ranks, one card each
(parallel/mesh.py): run alone, the CLI starts the N ranks itself (gloo
ranks on the CPU with `--device cpu`); inside a process group of N (for
example under torchrun) it joins it. Rank 0 writes the files.

`--hohonet_ckpt` (a HoHoNet `.pth`, built for `--hohonet_input_hw`): a
floor with a pano that has no cached depth map gets the depth of all its
panos computed on the card inside the scorer (pipeline/fused_inference.py),
with no PNG written or read; every rank of a mesh computes it. A floor
whose maps are all cached is scored from them. Without it, a missing map
is made through the depth cache's registered producer.

`--modalities ceiling_rgb_texture floor_rgb_texture layout` scores a
layout verifier (six images): each floor's room layouts and W/D/Os come
from the per-floor pose graphs of MHNet's predictions under
`--mhnet_predictions_data_root`, which the layout modality's file-contract
renderer reads (rendering/dataset_renderer.py:_render_layout_pairs), and a
hypothesis whose pano has no layout there is skipped, as that renderer
skips it. With `--horizonnet_ckpt` (a HorizonNet `.pth` for 512x1024
panos, a released `resnet50_rnn` file or one in its key layout) each pano's
floor boundary, and so its room, is computed on the card inside the scorer
instead (pipeline/fused_inference.py: `layout_model`), and only the W/D/O spans come from MHNet's predictions;
every rank of a mesh computes the boundaries.
"""

from __future__ import annotations

import argparse
import contextlib
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

RGB_MODALITIES = ("ceiling_rgb_texture", "floor_rgb_texture")


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
    mesh=None,
    depth_model=None,
    mhnet_predictions_data_root=None,
    layout_model=None,
) -> int:
    """Score every hypothesis of one building; write batch_{i}.json files.

    With a mesh every rank scores its rows of each batch and rank 0 writes
    the files (rank 0 fills a missing depth cache first). With a
    `depth_model` (a HoHoNetDepth) a floor that lacks a cached depth map
    has its depth computed inside the scorer instead (module docstring). A
    layout verifier (`cfg.modalities` holds `layout`) reads each floor's
    layouts from the MHNet predictions under `mhnet_predictions_data_root`;
    with a `layout_model` (a HorizonNet) only their W/D/O spans, each pano's
    room computed from its boundary inside the scorer. Returns the number of
    batch files written.
    """
    from salve_tpu_torch.common.alignment_hypothesis import AlignmentHypothesis
    from salve_tpu_torch.depth.cache import depth_fpath_for_pano, infer_depth_if_nonexistent
    from salve_tpu_torch.device import resolve_device
    from salve_tpu_torch.geometry.sim2 import Sim2
    from salve_tpu_torch.parallel.mesh import main_rank_first
    from salve_tpu_torch.pipeline.fused_inference import score_floor_hypotheses
    from salve_tpu_torch.rendering import bev_pair

    dev = resolve_device(device) if mesh is None else mesh.device
    writes = mesh is None or mesh.is_main
    if render_cfg is None:
        render_cfg = bev_pair.BEVRenderConfig()

    img_fpaths = glob.glob(f"{raw_dataset_dir}/{building_id}/panos/*.jpg")
    img_fpaths_dict = {int(Path(fp).stem.split("_")[-1]): fp for fp in img_fpaths}
    floor_pose_graphs = floor_predictions = None
    if "layout" in cfg.modalities:
        from salve_tpu_torch.dataset.hnet_prediction_loader import (load_hnet_predictions,
                                                                    load_inferred_floor_pose_graphs)

        if mhnet_predictions_data_root is None:
            raise ValueError("A layout verifier reads its layouts from MHNet predictions: give their root.")
        if layout_model is None:
            floor_pose_graphs = load_inferred_floor_pose_graphs(
                building_id=building_id, raw_dataset_dir=raw_dataset_dir,
                predictions_data_root=mhnet_predictions_data_root) or {}
        else:
            floor_predictions = load_hnet_predictions(
                building_id=building_id, raw_dataset_dir=raw_dataset_dir,
                predictions_data_root=mhnet_predictions_data_root) or {}

    n_written = 0
    floor_dirs = sorted(glob.glob(f"{hypotheses_save_root}/{building_id}/floor*"))
    for floor_dir in floor_dirs:
        floor_id = Path(floor_dir).name
        layout_panos = None
        if floor_pose_graphs is not None:
            layout_panos = floor_pose_graphs[floor_id].nodes if floor_id in floor_pose_graphs else {}
        elif floor_predictions is not None:
            layout_panos = floor_predictions.get(floor_id, {})

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
                if layout_panos is not None and (i1 not in layout_panos or i2 not in layout_panos):
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
        if depth_model is not None and not all(
                Path(depth_fpath_for_pano(depth_save_root, building_id, img_fpaths_dict[pid])).exists()
                for pid in pano_ids):
            depths = None
        else:
            with contextlib.nullcontext() if mesh is None else main_rank_first(mesh):
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
        layouts = wdo_spans = None
        if floor_predictions is not None:
            wdo_spans = [{t: [(w.s, w.e) for w in getattr(layout_panos[pid], t)] for t in ("doors", "windows",
                                                                                          "openings")}
                         for pid in pano_ids]
        elif layout_panos is not None:
            layouts = [(layout_panos[pid].room_vertices_local_2d, layout_panos[pid].all_wdos) for pid in pano_ids]

        t0 = time.time()
        results = score_floor_hypotheses(
            model, cfg, depths, rgbs, id2row, hyps,
            batch_size=batch_size, render_cfg=render_cfg,
            use_warp_renders=use_warp_renders, device=dev, mesh=mesh,
            depth_model=None if depths is not None else depth_model, layouts=layouts,
            layout_model=None if wdo_spans is None else layout_model, wdo_spans=wdo_spans,
        )
        elapsed = max(time.time() - t0, 1e-9)
        logger.info(
            "%s %s: scored %d hypotheses in %.1fs (%.1f hyp/s) on %s, depth %s",
            building_id, floor_id, len(results), elapsed, len(results) / elapsed, dev,
            "from the cache" if depths is not None else f"of {len(pano_ids)} panos computed on the card",
        )

        for start in range(0, len(results), batch_size):
            rs = results[start : start + batch_size]
            ms = meta[start : start + batch_size]
            if writes:
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
    p.add_argument("--mesh_devices", type=int, default=0,
                   help="Shard batches over an N-card mesh, one rank a card (0 = single device); run alone, the "
                        "CLI starts the N ranks (gloo ranks on the CPU with --device cpu).")
    warp = p.add_mutually_exclusive_group()
    warp.add_argument("--use_warp_renders", dest="use_warp_renders", action="store_true", default=None,
                      help="Render pano 1 per hypothesis as a Sim(2) warp of an extended identity bank "
                           "instead of a fresh splat. Default: on for CUDA, off on the CPU.")
    warp.add_argument("--no_warp_renders", dest="use_warp_renders", action="store_false", default=None)
    p.add_argument("--append_pair_difference", action="store_true",
                   help="Checkpoint was trained with explicit per-pair difference channels.")
    p.add_argument("--hohonet_ckpt", type=existing_path, default=None,
                   help="HoHoNet .pth: a floor lacking a cached depth map gets its depth computed on the card "
                        "inside the scorer, with no PNG written.")
    p.add_argument("--hohonet_input_hw", type=str, default="512,1024",
                   help="Input resolution the --hohonet_ckpt was built for; ep60 is the production 512,1024.")
    p.add_argument("--modalities", nargs="+", default=list(RGB_MODALITIES),
                   choices=["ceiling_rgb_texture", "floor_rgb_texture", "layout"],
                   help="The verifier's modalities: the ceiling and floor RGB textures (default), or those and the "
                        "layout (a six-image checkpoint, with --mhnet_predictions_data_root).")
    p.add_argument("--mhnet_predictions_data_root", type=str, default=None,
                   help="Root of the MHNet predictions (horizon_net/<building>/*.json) whose layouts and W/D/Os a "
                        "layout verifier scores, as the layout renderer reads them.")
    p.add_argument("--horizonnet_ckpt", type=existing_path, default=None,
                   help="HorizonNet .pth (resnet50_rnn): a layout verifier's rooms come from each pano's floor "
                        "boundary computed on the card inside the scorer, and only the W/D/O spans from the MHNet "
                        "predictions.")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu.")
    return p


def main(argv: Optional[List[str]] = None) -> None:
    run_test_fused(**vars(build_parser().parse_args(argv)))


def _run_rank(kwargs: dict) -> None:
    run_test_fused(**kwargs)


def run_test_fused(
    hypotheses_save_root, raw_dataset_dir, depth_save_root, ckpt_fpath,
    serialization_save_dir, building_id, num_layers, resize_px, crop_px,
    batch_size, mesh_devices, use_warp_renders, append_pair_difference, device,
    hohonet_ckpt, hohonet_input_hw, modalities=RGB_MODALITIES, mhnet_predictions_data_root=None,
    horizonnet_ckpt=None,
) -> None:
    options = dict(locals())
    logging.basicConfig(level=logging.INFO)
    import torch
    import torch.distributed as dist

    from salve_tpu_torch.device import resolve_device
    from salve_tpu_torch.parallel.mesh import launch, make_mesh
    from salve_tpu_torch.training.config import TrainingConfig

    dev = resolve_device(device)
    mesh = None
    if mesh_devices > 0:
        if dev.type == "cuda" and torch.cuda.device_count() < mesh_devices:
            raise ValueError(f"--mesh_devices {mesh_devices} but only {torch.cuda.device_count()} CUDA card(s) "
                             "visible")
        if batch_size % mesh_devices:
            raise ValueError(f"batch_size {batch_size} not divisible by mesh size {mesh_devices}")
        if mesh_devices > 1 and not dist.is_initialized():
            launch(_run_rank, mesh_devices, options, device=dev)
            return
        mesh = make_mesh((mesh_devices,), device=dev)

    cfg = TrainingConfig(
        num_layers=num_layers,
        modalities=tuple(modalities),
        resize_h=resize_px, resize_w=resize_px,
        train_h=crop_px, train_w=crop_px,
        batch_size=batch_size,
        append_pair_difference=append_pair_difference,
    )
    model = load_verifier(ckpt_fpath, cfg)
    depth_model = None
    if hohonet_ckpt is not None:
        from salve_tpu_torch.models.hohonet import load_hohonet

        depth_model = load_hohonet(hohonet_ckpt, tuple(int(v) for v in hohonet_input_hw.split(",")), device=dev)
    layout_model = None
    if horizonnet_ckpt is not None:
        if "layout" not in cfg.modalities:
            raise ValueError("--horizonnet_ckpt computes a layout verifier's rooms: give --modalities with layout.")
        from salve_tpu_torch.models.horizonnet import load_horizonnet

        layout_model = load_horizonnet(horizonnet_ckpt, device=dev)

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
            use_warp_renders=use_warp_renders, device=dev, mesh=mesh, depth_model=depth_model,
            mhnet_predictions_data_root=mhnet_predictions_data_root, layout_model=layout_model,
        )
    logger.info("wrote %d batch files to %s", total, serialization_save_dir)


if __name__ == "__main__":
    main()
