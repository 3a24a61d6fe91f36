"""CLI: global pose aggregation from verifier predictions (parity: scripts/run_sfm.py).

Port of salve_tpu/cli/run_sfm.py. Pipeline per (building, floor): parse
serialized predictions -> confidence threshold -> [optional RANSAC
spanning-tree edge filtering] -> most likely relative pose per edge ->
[optional vanishing-angle alignment] -> [optional global/local consistency
filtering] -> [optional rotation-conflict resolution and cluster rescue] ->
method dispatch (spanning_tree | pgo | pose2_slam | random_spanning_trees |
SE2_cycles | filtered_spanning_tree) -> report.

`run_incremental_reconstruction(..., device=None)` runs the pose-graph LM
and the report (RANSAC alignment, raster IoU) on the CUDA card and raises
without one; the graph work is host code. The parser is the standard
library's argparse, with the JAX package's flags:

    python -m salve_tpu_torch.cli.run_sfm --device cpu --method pose2_slam \
        --serialized_preds_json_dir PREDS --raw_dataset_dir ZIND \
        --hypotheses_save_root HYPS --use_axis_alignment false --rescue_clusters true

`plot_confidence_histograms` takes matplotlib through `utils/plotting.py`.
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from collections import defaultdict
from pathlib import Path
from typing import List, Optional

import numpy as np

from salve_tpu_torch.algorithms import (
    cluster_merging,
    cycle_consistency,
    global_local_consistency,
    pose2_slam,
    spanning_tree,
)
from salve_tpu_torch.cli.args import boolean, existing_path
from salve_tpu_torch.common import edge_classification, posegraph2d
from salve_tpu_torch.common.floor_reconstruction_report import (
    FloorReconstructionReport,
    summarize_reports,
)
from salve_tpu_torch.common.posegraph2d import PoseGraph2d
from salve_tpu_torch.dataset import hnet_prediction_loader
from salve_tpu_torch.device import DeviceLike, resolve_device
from salve_tpu_torch.utils import axis_alignment, graph_utils, plotting, pr_utils, profiler
from salve_tpu_torch.utils.io import save_json_file

logger = logging.getLogger(__name__)

DEFAULT_CONFIDENCE_THRESHOLD = 0.93  # scripts/run_sfm.py:617
METHODS = ["spanning_tree", "SE2_cycles", "filtered_spanning_tree", "random_spanning_trees", "pose2_slam", "pgo"]


def compute_floor_wdo_type_distribution(high_conf_measurements) -> dict:
    """Fraction of verified edges per W/D/O type (parity: run_sfm.py:38)."""
    wdo_type_counter = defaultdict(float)
    for m in high_conf_measurements:
        alignment_object = m.wdo_pair_uuid.split("_")[0]
        wdo_type_counter[alignment_object] += 1 / len(high_conf_measurements)
    return dict(wdo_type_counter)


def measure_avg_relative_pose_errors(
    measurements,
    gt_floor_pg,
    verbose: bool = False,
) -> tuple:
    """Mean per-edge relative (rot, trans) error vs GT (parity: run_sfm.py:55).

    A more reliable quality signal than edge classification accuracy
    (GT labels are noisy); works without an estimated global pose graph.
    """
    rot_errs, trans_errs = [], []
    for m in measurements:
        if m.i1 not in gt_floor_pg.nodes or m.i2 not in gt_floor_pg.nodes:
            continue
        rot_err, trans_err = m.compute_measurement_relative_pose_error_from_gt(
            gt_floor_pg
        )
        rot_errs.append(rot_err)
        trans_errs.append(trans_err)
        if verbose:
            logger.info("(%d,%d): rot %.2f deg, trans %.3f", m.i1, m.i2, rot_err, trans_err)
    if not rot_errs:
        return float("nan"), float("nan")
    mean_rot_err = float(np.mean(rot_errs))
    mean_trans_err = float(np.mean(trans_errs))
    logger.info(
        "Mean relative pose errors over %d edges: rot %.2f deg, trans %.3f",
        len(rot_errs), mean_rot_err, mean_trans_err,
    )
    return mean_rot_err, mean_trans_err


def plot_confidence_histograms(measurements, save_fpath: str = "confidence_histograms.png") -> None:
    """TP/FP/FN/TN confidence histograms (parity: run_sfm.py:197)."""
    plt = plotting.pyplot("plot_confidence_histograms")

    probs = np.array([m.prob for m in measurements])
    y_true = np.array([m.y_true for m in measurements])
    y_hat = np.array([m.y_hat for m in measurements])
    is_TP, is_FP, is_FN, is_TN = pr_utils.assign_tp_fp_fn_tn(y_true, y_hat)
    for i, (mask, title) in enumerate(
        [(is_TP, "TP"), (is_FP, "FP"), (is_FN, "FN"), (is_TN, "TN")]
    ):
        plt.subplot(2, 2, i + 1)
        plt.hist(probs[mask], bins=30)
        plt.title(title)
    plt.tight_layout()
    plt.savefig(save_fpath, dpi=200)
    plt.close("all")


def _empty_report(building_id=None, floor_id=None) -> FloorReconstructionReport:
    return FloorReconstructionReport(
        avg_abs_rot_err=np.nan,
        avg_abs_trans_err=np.nan,
        percent_panos_localized=0.0,
        floorplan_iou=0.0,
        building_id=building_id,
        floor_id=floor_id,
    )


def run_incremental_reconstruction(
    hypotheses_save_root: str,
    serialized_preds_json_dir: str,
    raw_dataset_dir: str,
    method: str,
    confidence_threshold: float,
    use_axis_alignment: bool,
    allowed_wdo_types: List[str],
    predictions_data_root: Optional[str],
    filter_edges_by_global_local_consistency: bool = False,
    filter_edges_by_random_spanning_trees: bool = False,
    plot_save_dir: Optional[str] = None,
    rescue_clusters: bool = False,
    rescue_min_conf: float = 0.5,
    resolve_rot_conflicts: bool = False,
    save_plots: bool = True,
    device: DeviceLike = None,
) -> List[FloorReconstructionReport]:
    """Run global optimization for every floor with serialized predictions.

    save_plots=False skips the pose serialization per floor (metrics only).
    `device` is where the pose-graph LM and the report run (None: the CUDA
    card; raises without one).
    """
    dev = resolve_device(device)
    if plot_save_dir is None:
        wdo_summary = "_".join(allowed_wdo_types)
        plot_save_dir = (
            f"{Path(serialized_preds_json_dir).name}___{method}_floorplans_with_conf"
            f"_{confidence_threshold}_{wdo_summary}_axisaligned{use_axis_alignment}"
        )
    os.makedirs(plot_save_dir, exist_ok=True)

    pairs = edge_classification.get_available_floor_ids_building_ids_from_serialized_preds(
        serialized_preds_json_dir
    )

    reports: List[FloorReconstructionReport] = []
    for building_id, floor_id in sorted(pairs):
        _t_stage = time.time()
        floor_ec_dict = edge_classification.get_edge_classifications_from_serialized_preds(
            query_building_id=building_id,
            query_floor_id=floor_id,
            serialized_preds_json_dir=serialized_preds_json_dir,
            hypotheses_save_root=hypotheses_save_root,
            allowed_wdo_types=allowed_wdo_types,
        )
        profiler.record_stage("sfm/load_preds", time.time() - _t_stage)
        measurements = floor_ec_dict[(building_id, floor_id)]
        if not measurements:
            logger.info("Skip %s %s: no measurements.", building_id, floor_id)
            reports.append(_empty_report(building_id, floor_id))
            continue

        inferred_floor_pose_graph = None
        if (use_axis_alignment or method == "pose2_slam") and predictions_data_root is not None:
            inferred_floor_pose_graph = hnet_prediction_loader.load_inferred_floor_pose_graph(
                building_id=building_id,
                floor_id=floor_id,
                raw_dataset_dir=raw_dataset_dir,
                predictions_data_root=predictions_data_root,
            )
        gt_floor_pose_graph = posegraph2d.get_gt_pose_graph(
            building_id, floor_id, raw_dataset_dir
        )
        logger.info("On building %s, %s", building_id, floor_id)

        high_conf_measurements = edge_classification.get_conf_thresholded_edge_measurements(
            measurements, confidence_threshold
        )
        if not high_conf_measurements:
            logger.info("Skip %s %s: no high-confidence measurements.", building_id, floor_id)
            reports.append(_empty_report(building_id, floor_id))
            continue

        if filter_edges_by_random_spanning_trees:
            _, high_conf_inlier_measurements = spanning_tree.ransac_spanning_trees(
                high_conf_measurements, num_hypotheses=100,
                gt_floor_pose_graph=gt_floor_pose_graph,
            )
        else:
            high_conf_inlier_measurements = high_conf_measurements

        wdo_type_counter = compute_floor_wdo_type_distribution(high_conf_measurements)
        logger.info("W/D/O type distribution: %s", wdo_type_counter)
        measure_avg_relative_pose_errors(high_conf_measurements, gt_floor_pose_graph)

        (
            i2Si1_dict,
            two_view_reports_dict,
            per_edge_wdo_dict,
            _,
        ) = edge_classification.get_most_likely_relative_pose_per_edge(
            high_conf_inlier_measurements, gt_floor_pose_graph
        )

        if use_axis_alignment and inferred_floor_pose_graph is not None:
            i2Si1_dict = axis_alignment.align_pairs_by_vanishing_angle(
                i2Si1_dict=i2Si1_dict,
                inferred_floor_pose_graph=inferred_floor_pose_graph,
                per_edge_wdo_dict=per_edge_wdo_dict,
            )

        if filter_edges_by_global_local_consistency:
            i2Si1_dict = global_local_consistency.filter_measurements_by_global_local_consistency(
                i2Si1_dict=i2Si1_dict,
                two_view_reports_dict=two_view_reports_dict,
                max_allowed_deviation_deg=5.0,
            )

        if rescue_clusters or resolve_rot_conflicts:
            # Shared sub-threshold pool for the rescue + conflict resolution:
            # POSITIVE predictions above the rescue floor (y_hat==0 entries
            # carry the negative class's confidence).
            rescue_pool = edge_classification.get_conf_thresholded_edge_measurements(
                measurements, rescue_min_conf
            )
            (
                i2Si1_all,
                two_view_all,
                per_edge_wdo_all,
                ec_all,
            ) = edge_classification.get_most_likely_relative_pose_per_edge(
                rescue_pool, gt_floor_pose_graph
            )
            if use_axis_alignment and inferred_floor_pose_graph is not None:
                i2Si1_all = axis_alignment.align_pairs_by_vanishing_angle(
                    i2Si1_dict=i2Si1_all,
                    inferred_floor_pose_graph=inferred_floor_pose_graph,
                    per_edge_wdo_dict=per_edge_wdo_all,
                )
            rescue_layouts = {
                i: np.asarray(pano.room_vertices_local_2d)
                for i, pano in gt_floor_pose_graph.nodes.items()
            }

        if resolve_rot_conflicts:
            # Composite wall-penetration conflict resolution: drop accepted
            # edge families whose composite placement drives walls through
            # freespace; the rescue below re-attaches the split wing.
            i2Si1_dict, dropped = cluster_merging.resolve_penetration_conflicts(
                i2Si1_dict, two_view_reports_dict, rescue_layouts,
                rescue_pool_i2Si1=i2Si1_all,
                rescue_pool_reports=two_view_all,
                all_nodes=set(gt_floor_pose_graph.nodes.keys()),
                min_conf=rescue_min_conf,
            )
            if dropped:
                dropped_set = set(dropped)
                high_conf_inlier_measurements = [
                    m
                    for m in high_conf_inlier_measurements
                    if (m.i1, m.i2) not in dropped_set
                ]
                logger.info(
                    "Rotation-conflict resolution: dropped %d accepted "
                    "edge(s) whose composite violated wall penetration: %s",
                    len(dropped), sorted(dropped_set),
                )

        if rescue_clusters:
            # Connectivity rescue: pull the most confident sub-threshold
            # crossings back in, one at a time, each gated by the
            # wall-penetration check, until none is acceptable.
            n_rescued = 0
            while True:
                merged = cluster_merging.merge_clusters(
                    i2Si1_all, i2Si1_dict, two_view_all,
                    pano_layouts=rescue_layouts,
                    all_nodes=set(gt_floor_pose_graph.nodes.keys()),
                    min_conf=rescue_min_conf,
                )
                if merged is None:
                    break
                for edge in set(merged) - set(i2Si1_dict):
                    high_conf_inlier_measurements.append(ec_all[edge])
                    two_view_reports_dict[edge] = two_view_all[edge]
                    per_edge_wdo_dict[edge] = per_edge_wdo_all[edge]
                    n_rescued += 1
                i2Si1_dict = merged
            if n_rescued:
                logger.info(
                    "Cluster rescue: accepted %d sub-threshold crossing(s).",
                    n_rescued,
                )

        _t_stage = time.time()
        if method == "spanning_tree":
            wSi_list = spanning_tree.greedily_construct_st_Sim2(i2Si1_dict, verbose=False)

        elif method in ("pose2_slam", "pgo"):
            wSi_list = spanning_tree.greedily_construct_st_Sim2(i2Si1_dict, verbose=False)
            wSi_list = pose2_slam.execute_planar_slam(
                measurements=high_conf_inlier_measurements,
                wSi_list=wSi_list,
                per_edge_wdo_dict=per_edge_wdo_dict,
                inferred_floor_pose_graph=inferred_floor_pose_graph,
                # W/D/O landmark factors need the inferred layouts; without
                # a predictions root, fall back to pose-only optimization.
                optimize_poses_only=(
                    method == "pgo" or inferred_floor_pose_graph is None
                ),
                device=dev,
            )

        elif method == "random_spanning_trees":
            wSi_list, _ = spanning_tree.ransac_spanning_trees(
                high_conf_measurements, num_hypotheses=100,
                gt_floor_pose_graph=gt_floor_pose_graph,
            )

        elif method == "SE2_cycles":
            i2Si1_dict = cycle_consistency.filter_to_SE2_cycle_consistent_edges(
                i2Si1_dict, two_view_reports_dict
            )
            if not i2Si1_dict:
                reports.append(_empty_report(building_id, floor_id))
                continue
            wSi_list = spanning_tree.greedily_construct_st_Sim2(i2Si1_dict, verbose=False)

        elif method == "filtered_spanning_tree":
            # Cycle-consistency filtering, then try to re-join split
            # components with the most confident low-confidence crossing,
            # then a greedy spanning tree.
            i2Si1_all = dict(i2Si1_dict)
            i2Si1_dict = cycle_consistency.filter_to_SE2_cycle_consistent_edges(
                i2Si1_dict, two_view_reports_dict
            )
            if not i2Si1_dict:
                reports.append(_empty_report(building_id, floor_id))
                continue
            pano_layouts = {
                i: np.asarray(pano.room_vertices_local_2d)
                for i, pano in gt_floor_pose_graph.nodes.items()
            }
            merged = cluster_merging.merge_clusters(
                i2Si1_all, i2Si1_dict, two_view_reports_dict,
                pano_layouts=pano_layouts,
            )
            if merged is not None:
                i2Si1_dict = merged
            wSi_list = spanning_tree.greedily_construct_st_Sim2(i2Si1_dict, verbose=False)

        else:
            raise RuntimeError(f"Unknown method {method}.")

        profiler.record_stage("sfm/optimize", time.time() - _t_stage)
        if wSi_list is None:
            reports.append(_empty_report(building_id, floor_id))
            continue

        est_floor_pose_graph = PoseGraph2d.from_wSi_list(wSi_list, gt_floor_pose_graph)
        with profiler.stage_timer("sfm/report"):
            report = FloorReconstructionReport.from_est_floor_pose_graph(
                est_floor_pose_graph, gt_floor_pose_graph,
                plot_save_dir=plot_save_dir if save_plots else None,
                device=dev,
            )
            # Paper completeness metric (index.html:246): % of the floor's
            # panos inside the top-2/3 connected components of the edge
            # graph the aggregation method actually used (unlocalized panos
            # count as singleton components).
            _, cc_cdf = graph_utils.analyze_cc_distribution(
                nodes=list(gt_floor_pose_graph.nodes.keys()),
                edges=list(i2Si1_dict.keys()),
            )
            if len(cc_cdf):
                report.percent_in_top2_ccs = 100.0 * float(
                    cc_cdf[min(1, len(cc_cdf) - 1)]
                )
                report.percent_in_top3_ccs = 100.0 * float(
                    cc_cdf[min(2, len(cc_cdf) - 1)]
                )
            reports.append(report)

    summary = summarize_reports(reports)
    for k, v in summary.items():
        logger.info("%s = %.3f", k, v)
    save_json_file(f"{plot_save_dir}/summary.json", summary)
    profiler.save_stage_summary(f"{plot_save_dir}/stage_timings.json")
    logger.info("stage timings: %s", profiler.stage_summary())
    return reports


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Run SfM using SALVe verifier predictions.")
    p.add_argument("--serialized_preds_json_dir", type=existing_path, required=True,
                   help="Directory where serialized predictions were saved to (from test.py).")
    p.add_argument("--raw_dataset_dir", type=existing_path, required=True,
                   help="Path to where ZInD dataset is stored on disk.")
    p.add_argument("--hypotheses_save_root", type=existing_path, required=True,
                   help="Directory where alignment-hypothesis JSONs were saved.")
    p.add_argument("--method", required=True, choices=METHODS, help="Global aggregation method.")
    p.add_argument("--mhnet_predictions_data_root", type=existing_path, default=None,
                   help="Path to directory containing MHNet predictions.")
    p.add_argument("--confidence_threshold", type=float, default=DEFAULT_CONFIDENCE_THRESHOLD,
                   help="Minimum verifier confidence to accept a prediction.")
    p.add_argument("--use_axis_alignment", type=boolean, default=True,
                   help="Refine relative poses by estimated vanishing angles.")
    p.add_argument("--filter_edges_by_global_local_consistency", type=boolean, default=False)
    p.add_argument("--filter_edges_by_random_spanning_trees", type=boolean, default=False)
    p.add_argument("--rescue_clusters", type=boolean, default=False,
                   help="Re-join split components / stranded panos with the most "
                        "confident sub-threshold crossings (wall-penetration gated).")
    p.add_argument("--rescue_min_conf", type=float, default=0.5,
                   help="Confidence floor below which crossings are never rescued.")
    p.add_argument("--resolve_rot_conflicts", type=boolean, default=False,
                   help="Drop accepted-edge families whose composite placement "
                        "drives walls through freespace (wrong-rotation wing "
                        "attachments), then let --rescue_clusters re-attach.")
    p.add_argument("--device", type=str, default="cuda",
                   help="Where the pose-graph LM and the report run ('cuda' or 'cpu'; default: cuda).")
    return p


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    run_incremental_reconstruction(
        hypotheses_save_root=args.hypotheses_save_root,
        serialized_preds_json_dir=args.serialized_preds_json_dir,
        raw_dataset_dir=args.raw_dataset_dir,
        method=args.method,
        confidence_threshold=args.confidence_threshold,
        use_axis_alignment=args.use_axis_alignment,
        allowed_wdo_types=["door", "window", "opening"],
        predictions_data_root=args.mhnet_predictions_data_root,
        filter_edges_by_global_local_consistency=args.filter_edges_by_global_local_consistency,
        filter_edges_by_random_spanning_trees=args.filter_edges_by_random_spanning_trees,
        rescue_clusters=args.rescue_clusters,
        rescue_min_conf=args.rescue_min_conf,
        resolve_rot_conflicts=args.resolve_rot_conflicts,
        device=args.device,
    )


if __name__ == "__main__":
    main()
