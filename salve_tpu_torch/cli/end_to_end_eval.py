"""CLI: end-to-end accuracy evaluation on synthesized ZInD buildings (port of
salve_tpu/cli/end_to_end_eval.py).

Runs the whole pipeline through its file contracts, every stage the port's
own: GT layouts -> panos ray-cast through each floor's multi-room world
(`dataset/synthetic_zind.py`) and the u16 depth cache -> Stage A hypotheses
(`hypotheses/export.py`) -> Stage B BEV renders
(`rendering/dataset_renderer.py`) -> Stage C verifier training and
`evaluate` (`training/loop.py`), an optional val calibration
(`training/calibration.py`) -> Stage D reconstruction and the floor report
(`cli/run_sfm.py`) -> one JSON of verifier and reconstruction metrics,
`end_to_end_eval.json`, with the keys of salve_tpu's.

The same options as the click original, on argparse and under the same
spellings, plus `--device` (default cuda; the CPU only when asked). The
checkpoint Stage C scores is the newest `ckpts/*/train_ckpt.pt`;
`--finetune_ckpt` and `--resume_ckpt` also take salve_tpu's `.flax`. The
warp arm of the corpus follows `--warp_corpus/--no_warp_corpus`, by default
on for the card and off on the CPU; the summary records the flag as given.
Plots are not drawn: Stage D serializes poses only.
Stage C's training and scoring, the calibration's included, run under
`device.deterministic_algorithms()` (in `train()` and `evaluate()`), and
`main` sets cuBLAS's workspace for it: one seed gives the same checkpoint and
probabilities on every run.

    python -m salve_tpu_torch.cli.end_to_end_eval --src_zind_dir ZIND --output_dir OUT \\
        --procedural_val_buildings 1 --calibrate_on_val [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

from salve_tpu_torch.cli.args import UsageError, existing_path
from salve_tpu_torch.device import set_cublas_workspace_config

logger = logging.getLogger(__name__)

MODALITIES = ["ceiling_rgb_texture", "floor_rgb_texture", "layout"]
DEFAULT_MODALITIES = ("ceiling_rgb_texture", "floor_rgb_texture")
ALLOWED_WDO_TYPES = ["door", "window", "opening"]
# --freeze_method_on_val's Stage D configurations, simplest first: ties elect
# the simpler one.
FREEZE_CONFIG_GRID = [
    ("pose2_slam", {"rescue_clusters": False, "glc": False, "rotfix": False}),
    ("pose2_slam_rescue", {"rescue_clusters": True, "glc": False, "rotfix": False}),
    ("pose2_slam_glc", {"rescue_clusters": False, "glc": True, "rotfix": False}),
    ("pose2_slam_glc_rescue", {"rescue_clusters": True, "glc": True, "rotfix": False}),
    ("pose2_slam_rotfix_rescue", {"rescue_clusters": True, "glc": False, "rotfix": True}),
    ("pose2_slam_glc_rotfix_rescue", {"rescue_clusters": True, "glc": True, "rotfix": True}),
]


def _finite(x):
    """float(x), or None when missing or not finite (keeps the JSON strict)."""
    return float(x) if x is not None and np.isfinite(x) else None


def _report_dict(r):
    """One reconstruction summary entry (shared by full and Stage-D-only runs)."""
    return {
        "building_id": r.building_id,
        "floor_id": r.floor_id,
        "avg_abs_rot_err_deg": _finite(r.avg_abs_rot_err),
        "avg_abs_trans_err": _finite(r.avg_abs_trans_err),
        "percent_panos_localized": _finite(r.percent_panos_localized),
        "floorplan_iou": _finite(r.floorplan_iou),
        "percent_in_top2_ccs": _finite(r.percent_in_top2_ccs),
        "percent_in_top3_ccs": _finite(r.percent_in_top3_ccs),
    }


def _per_building_verifier(preds_dir: Path) -> dict:
    """Per-building precision / recall / mAcc of the serialized
    batch_{i}.json predictions, grouped by the BEV render's parent directory
    (the building id)."""
    counts: dict = {}
    for fpath in sorted(preds_dir.glob("batch_*.json")):
        d = json.loads(fpath.read_text())
        for yh, yt, fp0 in zip(d["y_hat"], d["y_true"], d["fp0"]):
            c = counts.setdefault(Path(fp0).parent.name, {"tp": 0, "fp": 0, "fn": 0, "tn": 0})
            key = ("fn", "tn")[yh == yt] if yh == 0 else ("fp", "tp")[yh == yt]
            c[key] += 1
    out = {}
    for bid, c in sorted(counts.items()):
        npos, nneg = c["tp"] + c["fn"], c["tn"] + c["fp"]
        out[bid] = {
            "precision": c["tp"] / (c["tp"] + c["fp"]) if c["tp"] + c["fp"] else None,
            "recall": c["tp"] / npos if npos else None,
            "mAcc": 0.5 * (c["tp"] / npos + c["tn"] / nneg) if npos and nneg else None,
            "num_pairs": npos + nneg,
        }
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="End-to-end accuracy run on synthesized fixture buildings.")
    p.add_argument("--src_zind_dir", type=existing_path, default="/root/reference/tests/test_data/ZInD")
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--train_building", type=str, default="0000")
    p.add_argument("--eval_building", type=str, default="1210")
    p.add_argument("--num_layers", type=int, default=18)
    p.add_argument("--num_epochs", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--resize_px", type=int, default=128)
    p.add_argument("--crop_px", type=int, default=112)
    p.add_argument("--depth_ckpt", type=str, default=None,
                   help="Trained PanoDepthNet checkpoint; default uses exact GT depth.")
    p.add_argument("--depth_num_layers", type=int, default=50)
    p.add_argument("--confidence_threshold", type=float, default=0.5)
    p.add_argument("--method", type=str, default="pose2_slam")
    p.add_argument("--modalities", action="append", choices=MODALITIES, default=None,
                   help="Verifier input modalities (repeat the flag; default ceiling_rgb_texture and "
                        "floor_rgb_texture). Including 'layout' renders rasterized room-layout pairs next to "
                        "the RGB textures and trains the widened-stem model on the tuple the set implies.")
    p.add_argument("--procedural_train_buildings", type=int, default=0,
                   help="Additionally generate N procedural buildings (train-split ids).")
    p.add_argument("--procedural_val_buildings", type=int, default=0,
                   help="Generate N procedural buildings with val-split ids, so checkpoint selection and "
                        "calibration use a held-out val split.")
    p.add_argument("--procedural_val_pathological", type=int, default=0,
                   help="Generate N additional val-split buildings of style 'pathological' (two wings joined "
                        "by single-door bridge edges).")
    p.add_argument("--procedural_val_rotation_traps", type=int, default=0,
                   help="Generate N additional val-split buildings of style 'rotation_trap' (equal door "
                        "widths and same-width door twins).")
    p.add_argument("--procedural_version", type=int, default=11,
                   help="Generator version for train and val procedural ids; eval ids always use v11.")
    p.add_argument("--eval_procedural_buildings", type=int, default=0,
                   help="Generate N never-trained-on procedural buildings with test-split ids and score them "
                        "alongside --eval_building.")
    p.add_argument("--photometric_augmentation", action="store_true")
    p.add_argument("--append_pair_difference", action="store_true",
                   help="Feed explicit per-pair difference channels to the verifier stem.")
    p.add_argument("--resume_ckpt", type=str, default=None,
                   help="Checkpoint to restore params and optimizer state from before training.")
    p.add_argument("--finetune_ckpt", type=str, default=None,
                   help="Checkpoint to restore params and batch stats only (fresh optimizer and LR schedule).")
    p.add_argument("--calibrate_on_val", action="store_true",
                   help="Fit temperature scaling and one frozen operating point on the val split, then run the "
                        "held-out Stage D at that point (overrides --confidence_threshold).")
    p.add_argument("--warp_corpus", dest="warp_corpus", action="store_true",
                   help="Render the corpus img1s as Sim(2) warps of per-pano identity banks.")
    p.add_argument("--no_warp_corpus", dest="warp_corpus", action="store_false",
                   help="Render every pair directly (default on the CPU).")
    p.set_defaults(warp_corpus=None)
    p.add_argument("--decoded_cache_gb", type=float, default=None,
                   help="In-RAM decoded-image cache budget for the train loop (default 8).")
    p.add_argument("--device_corpus_gb", type=float, default=None,
                   help="Device-memory budget for an on-device uint8 train corpus; 0/unset streams from host.")
    p.add_argument("--stage_d_only", action="store_true",
                   help="Reuse an existing output_dir (hypotheses and serialized predictions) and re-run only "
                        "Stage D. Writes a suffixed summary JSON.")
    p.add_argument("--rescue_clusters", action="store_true",
                   help="Stage D connectivity rescue (algorithms/cluster_merging.py), in the calibration sweep "
                        "and the held-out reconstruction alike.")
    p.add_argument("--glc", action="store_true",
                   help="Filter edges by global/local consistency before aggregation.")
    p.add_argument("--rotfix", action="store_true",
                   help="Resolve contested wing attachments among accepted edges "
                        "(cluster_merging.py:resolve_penetration_conflicts).")
    p.add_argument("--freeze_method_on_val", action="store_true",
                   help="Extend --calibrate_on_val to also elect the Stage D configuration on val, and run "
                        "the held-out Stage D once at the frozen (configuration, threshold).")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu.")
    return p


def _procedural_sources(args, out: Path, src_dirs: dict) -> list:
    """Write the requested procedural buildings under out/procedural_zind;
    map their ids to it in `src_dirs`. Returns the eval (test-split) ids."""
    from salve_tpu_torch.dataset.procedural import write_procedural_buildings
    from salve_tpu_torch.dataset.zind_partition import DATASET_SPLITS

    fixed = (args.train_building, args.eval_building)
    # Procedural geometry rides unused train/val/test-split ids, so split
    # discovery (dataset/bev_pairs.py) picks it up unchanged.
    proc_ids = [bid for bid in sorted(DATASET_SPLITS["train"]) if bid not in fixed][: args.procedural_train_buildings]
    val_pool = [bid for bid in sorted(DATASET_SPLITS["val"]) if bid not in fixed]
    n_val, n_patho = args.procedural_val_buildings, args.procedural_val_pathological
    proc_ids += val_pool[:n_val]
    # Pathological, then rotation-trap val buildings take the next unused
    # val ids, so earlier val ids keep their geometry.
    patho_ids = val_pool[n_val: n_val + n_patho]
    rot_ids = val_pool[n_val + n_patho: n_val + n_patho + args.procedural_val_rotation_traps]
    proc_ids += patho_ids + rot_ids
    # Held-out ids are always generated at v11, so their geometry is frozen.
    eval_proc_ids = [bid for bid in sorted(DATASET_SPLITS["test"]) if bid not in fixed][
        : args.eval_procedural_buildings]
    proc_src = out / "procedural_zind"
    styles = {bid: "pathological" for bid in patho_ids}
    styles.update({bid: "rotation_trap" for bid in rot_ids})
    write_procedural_buildings(str(proc_src), proc_ids, base_seed=7, version=args.procedural_version, styles=styles)
    write_procedural_buildings(str(proc_src), eval_proc_ids, base_seed=7, version=11)
    proc_ids += eval_proc_ids
    for bid in proc_ids:
        src_dirs[bid] = str(proc_src)
    logger.info("generated %d procedural buildings (%d train / %d val / %d patho-val / %d rot-trap-val / %d eval ids)",
                len(proc_ids), args.procedural_train_buildings, n_val, len(patho_ids), len(rot_ids),
                len(eval_proc_ids))
    return eval_proc_ids


def _reconstruct(hyp_root: Path, preds_dir: Path, raw_dir: Path, method: str, threshold: float, plot_dir: Path,
                 flags: dict, dev, save_plots: bool = True):
    from salve_tpu_torch.cli.run_sfm import run_incremental_reconstruction

    return run_incremental_reconstruction(
        hypotheses_save_root=str(hyp_root),
        serialized_preds_json_dir=str(preds_dir),
        raw_dataset_dir=str(raw_dir),
        method=method,
        confidence_threshold=threshold,
        use_axis_alignment=False,
        allowed_wdo_types=ALLOWED_WDO_TYPES,
        predictions_data_root=None,
        plot_save_dir=str(plot_dir),
        rescue_clusters=flags["rescue_clusters"],
        filter_edges_by_global_local_consistency=flags["glc"],
        resolve_rot_conflicts=flags.get("rotfix", False),
        save_plots=save_plots,
        device=dev,
    )


def _reconstruction_summary(reports) -> dict:
    from salve_tpu_torch.common.floor_reconstruction_report import summarize_reports

    return {k: _finite(v) for k, v in summarize_reports(reports).items()}


def training_config(args: argparse.Namespace, out: Path):
    """The Stage C TrainingConfig the options give, for the output dir `out`."""
    from salve_tpu_torch.training.config import TrainingConfig

    modalities = tuple(args.modalities) if args.modalities else DEFAULT_MODALITIES
    use_layout = "layout" in modalities
    layout_root, bev_root = out / "layout", out / "bev"
    cfg = TrainingConfig(
        num_layers=args.num_layers,
        resize_h=args.resize_px, resize_w=args.resize_px,
        train_h=args.crop_px, train_w=args.crop_px,
        batch_size=args.batch_size,
        num_epochs=args.num_epochs,
        workers=4,
        modalities=modalities,
        # Layout-only tuples are discovered by globbing data_root itself.
        data_root=str(layout_root) if set(modalities) == {"layout"} else str(bev_root),
        layout_data_root=str(layout_root) if use_layout else "",
        model_save_dirpath=str(out / "ckpts"),
        # Fixture-scale data is about 1:8 imbalanced; plain CE collapses.
        class_balanced_loss=True,
        apply_photometric_augmentation=args.photometric_augmentation,
        append_pair_difference=args.append_pair_difference,
        # The requested buildings keep their roles whatever the partition says.
        split_overrides={args.train_building: "train", args.eval_building: "test"},
    )
    if args.decoded_cache_gb is not None:
        cfg.decoded_cache_gb = args.decoded_cache_gb
    if args.device_corpus_gb is not None:
        cfg.device_corpus_gb = args.device_corpus_gb
    return cfg


def run_end_to_end_eval(args: argparse.Namespace) -> dict:
    """Run as the options say; writes and returns the summary dict.
    Raises UsageError where the click original raises click.UsageError."""
    from salve_tpu_torch.device import resolve_device

    modalities = tuple(args.modalities) if args.modalities else DEFAULT_MODALITIES
    if args.num_epochs == 0 and not (args.finetune_ckpt or args.resume_ckpt) and not args.stage_d_only:
        raise UsageError("--num_epochs 0 is eval-only: pass the checkpoint to score via --finetune_ckpt or "
                         "--resume_ckpt")
    dev = resolve_device(args.device)
    t_start = time.time()
    out = Path(args.output_dir)
    raw_dir, depth_root = out / "zind", out / "depth"
    hyp_root, bev_root = out / "hypotheses", out / "bev"
    preds_dir, plots_dir = out / "preds", out / "plots"
    layout_root = out / "layout"
    use_layout = "layout" in modalities
    for d in (raw_dir, depth_root, hyp_root, bev_root, preds_dir, plots_dir):
        d.mkdir(parents=True, exist_ok=True)
    if use_layout:
        layout_root.mkdir(parents=True, exist_ok=True)
    flags = {"rescue_clusters": args.rescue_clusters, "glc": args.glc, "rotfix": args.rotfix}

    if args.stage_d_only:
        return _run_stage_d_only(out, hyp_root, raw_dir, preds_dir, plots_dir, args.method,
                                 args.confidence_threshold, t_start, flags, dev)

    from salve_tpu_torch.common import posegraph2d
    from salve_tpu_torch.dataset.synthetic_zind import materialize_synthetic_building
    from salve_tpu_torch.hypotheses.export import export_single_building_wdo_alignment_hypotheses
    from salve_tpu_torch.rendering.dataset_renderer import render_building_floor_pairs
    from salve_tpu_torch.training import loop as train_loop

    depth_provider = None
    if args.depth_ckpt:
        from salve_tpu_torch.models.depth_net import load_depth_provider

        depth_provider = load_depth_provider(args.depth_ckpt, num_layers=args.depth_num_layers, device=dev)

    src_dirs = {args.train_building: args.src_zind_dir, args.eval_building: args.src_zind_dir}
    eval_proc_ids: list = []
    if (args.procedural_train_buildings > 0 or args.procedural_val_buildings > 0
            or args.procedural_val_pathological > 0 or args.procedural_val_rotation_traps > 0
            or args.eval_procedural_buildings > 0):
        eval_proc_ids = _procedural_sources(args, out, src_dirs)

    timings = {}
    for bid in sorted(src_dirs):
        t0 = time.time()
        floors = materialize_synthetic_building(src_dirs[bid], bid, str(raw_dir), depth_save_root=str(depth_root),
                                                depth_provider=depth_provider)
        timings[f"materialize_{bid}_s"] = round(time.time() - t0, 2)
        logger.info("materialized %s: %s", bid, floors)

        t0 = time.time()
        # Resume contract: a building whose hypothesis JSONs exist is not
        # re-exported.
        if not any(Path(hyp_root, bid).rglob("*.json")):
            export_single_building_wdo_alignment_hypotheses(
                hypotheses_save_root=str(hyp_root), building_id=bid,
                json_annot_fpath=str(raw_dir / bid / "zind_data.json"), raw_dataset_dir=str(raw_dir),
                use_inferred_wdos_layout=False, device=dev)
        timings[f"stage_a_{bid}_s"] = round(time.time() - t0, 2)

        t0 = time.time()
        n_pairs = 0
        for floor_id in posegraph2d.compute_available_floors_for_building(bid, str(raw_dir)):
            # The layout modality rasterizes the GT pose graph's rooms, the
            # geometry the RGB raycasts come from.
            floor_pg = posegraph2d.get_gt_pose_graph(bid, floor_id, str(raw_dir)) if use_layout else None
            n_pairs += render_building_floor_pairs(
                depth_save_root=str(depth_root), bev_save_root=str(bev_root), hypotheses_save_root=str(hyp_root),
                raw_dataset_dir=str(raw_dir), building_id=bid, floor_id=floor_id,
                layout_save_root=str(layout_root) if use_layout else None,
                render_modalities=["rgb_texture", "layout"] if use_layout else ["rgb_texture"],
                floor_pose_graph=floor_pg, use_warp=args.warp_corpus, device=dev)
        timings[f"stage_b_{bid}_s"] = round(time.time() - t0, 2)
        logger.info("rendered %d pairs for %s", n_pairs, bid)

    # --- Stage C: train on the train split, score the test split. ---------
    cfg = training_config(args, out)
    if args.num_epochs == 0:
        # Eval-only: score an existing checkpoint without training.
        ckpt_fpath = args.finetune_ckpt or args.resume_ckpt
        results = None
        timings["stage_c_train_s"] = 0.0
    else:
        t0 = time.time()
        results = train_loop.train(cfg, resume_from=args.resume_ckpt, finetune_from=args.finetune_ckpt, device=dev)
        timings["stage_c_train_s"] = round(time.time() - t0, 2)
        ckpts = sorted(glob.glob(str(out / "ckpts" / "*" / "train_ckpt.pt")))
        assert ckpts, "training saved no checkpoint"
        ckpt_fpath = ckpts[-1]

    t0 = time.time()
    prec, rec, mAcc = train_loop.evaluate(cfg, ckpt_fpath, "test", str(preds_dir), device=dev)
    timings["stage_c_eval_s"] = round(time.time() - t0, 2)
    logger.info("verifier on test split: prec %.3f rec %.3f mAcc %.3f", prec, rec, mAcc)

    # --- Stage D: reconstruction and metrics on the held-out building. ----
    calibration_summary = None
    confidence_threshold = args.confidence_threshold
    if args.calibrate_on_val or args.freeze_method_on_val:
        config_grid = FREEZE_CONFIG_GRID if args.freeze_method_on_val else [(args.method, dict(flags))]
        t0 = time.time()
        calibration_summary, confidence_threshold, flags = _calibrate_on_val_split(
            cfg, ckpt_fpath, out, hyp_root, raw_dir, plots_dir, args.method, config_grid=config_grid, device=dev)
        timings["calibration_s"] = round(time.time() - t0, 2)
        logger.info("frozen operating point from val: raw conf %.4f (T=%.3f) config=%s", confidence_threshold,
                    calibration_summary["temperature"], calibration_summary.get("frozen_config"))

    t0 = time.time()
    reports = _reconstruct(hyp_root, preds_dir, raw_dir, args.method, confidence_threshold, plots_dir, flags, dev)
    timings["stage_d_s"] = round(time.time() - t0, 2)

    summary = {
        "train_building": args.train_building,
        "eval_building": args.eval_building,
        "eval_procedural_buildings": eval_proc_ids,
        "verifier": {
            "precision": float(prec),
            "recall": float(rec),
            "mAcc": float(mAcc),
            "per_building": _per_building_verifier(preds_dir),
            "ckpt": ckpt_fpath,
            "train_mAcc_last": float(results["train_mAcc"][-1]) if results else None,
            "val_mAcc_best": float(max(results["val_mAcc"])) if results else None,
            "train_mAcc_history": [float(v) for v in results["train_mAcc"]] if results else [],
            "num_layers": args.num_layers,
            "num_epochs": args.num_epochs,
            "modalities": list(modalities),
        },
        "depth": "model:" + args.depth_ckpt if args.depth_ckpt else "gt_raycast",
        "reconstruction": [_report_dict(r) for r in reports],
        # The corpus rollup in summarize_reports' format.
        "reconstruction_summary": _reconstruction_summary(reports),
        "method": args.method,
        "rescue_clusters": flags["rescue_clusters"],
        "glc": flags["glc"],
        "rotfix": flags["rotfix"],
        "confidence_threshold": confidence_threshold,
        "calibration": calibration_summary,
        "warp_corpus": args.warp_corpus,
        "timings_s": timings,
        "total_wallclock_s": round(time.time() - t_start, 2),
    }
    with open(out / "end_to_end_eval.json", "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return summary


def _calibrate_on_val_split(
    cfg, ckpt_fpath, out, hyp_root, raw_dir, plots_dir, method,
    threshold_grid=(0.5, 0.7, 0.8, 0.9, 0.93),
    config_grid=None,
    device=None,
):
    """Fit a temperature and freeze one operating point on the val split only.

    1. Score the val split (procedural val-id buildings) -> val batch JSONs,
       kept per checkpoint (`val_preds_<ckpt dir>`).
    2. Fit a scalar temperature by NLL (training/calibration.py).
    3. Sweep calibrated thresholds, and the Stage D configurations of
       `config_grid`, through the full Stage D of the val buildings; freeze
       the (configuration, threshold) of best mean floorplan IoU (ties:
       higher localization, then higher threshold, then the earlier =
       simpler configuration).
    Returns (summary_dict, frozen_raw_threshold, frozen_flags).
    """
    from salve_tpu_torch.training import calibration
    from salve_tpu_torch.training import loop as train_loop

    if config_grid is None:
        config_grid = [(method, {"rescue_clusters": False, "glc": False, "rotfix": False})]

    ckpt_tag = Path(ckpt_fpath).parent.name if ckpt_fpath else "none"
    val_preds_dir = out / f"val_preds_{ckpt_tag}"
    val_preds_dir.mkdir(parents=True, exist_ok=True)
    if not any(val_preds_dir.glob("batch_*.json")):
        train_loop.evaluate(cfg, ckpt_fpath, "val", str(val_preds_dir), device=device)
    if not any(val_preds_dir.glob("batch_*.json")):
        raise UsageError("--calibrate_on_val needs a non-empty val split: pass --procedural_val_buildings N so "
                         "val-id buildings are rendered.")

    fit = calibration.fit_from_preds(str(val_preds_dir))
    temperature = fit["temperature"]

    sweep = {}
    best = None  # (iou, loc, t_cal, -config_rank): the earlier config wins ties
    best_sel = None  # (t_raw, flags, config_name, t_cal)
    for rank, (config_name, flags) in enumerate(config_grid):
        cfg_sweep = {}
        for t_cal in threshold_grid:
            t_raw = calibration.raw_threshold_for_calibrated(t_cal, temperature)
            reports = _reconstruct(hyp_root, val_preds_dir, raw_dir, method, t_raw,
                                   plots_dir / f"val_calib_{config_name}_{t_cal:g}", flags, device, save_plots=False)
            ious = [r.floorplan_iou for r in reports if r.floorplan_iou is not None]
            locs = [r.percent_panos_localized for r in reports if r.percent_panos_localized is not None]
            mean_iou = float(np.mean(ious)) if ious else 0.0
            mean_loc = float(np.mean(locs)) if locs else 0.0
            cfg_sweep[f"{t_cal:g}"] = {
                "raw_equivalent": round(float(t_raw), 4),
                "val_mean_iou": round(mean_iou, 4),
                "val_mean_loc": round(mean_loc, 2),
                "n_floors": len(ious),
            }
            key = (round(mean_iou, 4), round(mean_loc, 2), t_cal, -rank)
            if best is None or key > best:
                best = key
                best_sel = (float(t_raw), dict(flags), config_name, t_cal)
        sweep[config_name] = cfg_sweep

    t_raw, flags, config_name, t_cal = best_sel
    summary = dict(fit)
    summary["val_reconstruction_sweep"] = sweep
    summary["frozen_threshold_calibrated"] = t_cal
    summary["frozen_threshold_raw"] = round(t_raw, 4)
    summary["frozen_config"] = config_name
    summary["frozen_flags"] = flags
    summary["selection_rule"] = "max val mean IoU (ties: loc, then threshold, then simpler config)"
    return summary, t_raw, flags


def _run_stage_d_only(out, hyp_root, raw_dir, preds_dir, plots_dir, method, confidence_threshold, t_start, flags,
                      device) -> dict:
    """Stage D over a prior run's hypotheses and serialized predictions."""
    assert any(preds_dir.glob("*.json")), (
        f"--stage_d_only needs serialized predictions in {preds_dir} (run the full pipeline once first)"
    )
    reports = _reconstruct(hyp_root, preds_dir, raw_dir, method, confidence_threshold, plots_dir, flags, device)
    summary = {
        "stage_d_only": True,
        "method": method,
        "rescue_clusters": flags["rescue_clusters"],
        "glc": flags["glc"],
        "rotfix": flags["rotfix"],
        "confidence_threshold": confidence_threshold,
        "reconstruction": [_report_dict(r) for r in reports],
        "reconstruction_summary": _reconstruction_summary(reports),
        "total_wallclock_s": round(time.time() - t_start, 2),
    }
    tag = f"{method}_conf{confidence_threshold:g}"
    if flags["glc"]:
        tag += "_glc"
    if flags["rotfix"]:
        tag += "_rotfix"
    if flags["rescue_clusters"]:
        tag += "_rescue"
    with open(out / f"end_to_end_eval_stage_d_{tag}.json", "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return summary


def main(argv: Optional[List[str]] = None) -> dict:
    set_cublas_workspace_config()
    parser = build_parser()
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    try:
        return run_end_to_end_eval(args)
    except UsageError as e:
        parser.error(str(e))


if __name__ == "__main__":
    main()
