"""CLI: stitch localized per-pano layouts into a final floorplan.

Parity: scripts/stitch_floor_plan_new.py (the reference's old script is
WIP/broken — live pdb.set_trace() at scripts/stitch_floor_plan.py:73 — so
this follows the new flow: salve_sfm_result_loader poses + room merging +
confidence-weighted shape fusion).

A copy of salve_tpu/cli/stitch_floor_plan.py (no JAX), on argparse instead of
click, with `--device` (default: the CUDA card) for the room-grouping raster.
`stitch_building_layouts` writes salve_tpu's `fused/final.png` and also
returns the fused shapes. The figure is a side figure (`utils/plotting.py`,
rule (b)): without matplotlib it is left out, with one warning a process.

    python -m salve_tpu_torch.cli.stitch_floor_plan --raw_dataset_dir ZIND \\
        --est-localization-fpath SERIALIZED.json -o OUT --hnet-pred-dir PREDS --device cpu
"""

from __future__ import annotations

import argparse
import logging
import os
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from salve_tpu_torch.algorithms import room_merging as room_merging_algo
from salve_tpu_torch.cli.args import existing_path
from salve_tpu_torch.dataset import hnet_prediction_loader, salve_sfm_result_loader
from salve_tpu_torch.dataset.salve_sfm_result_loader import EstimatedBoundaryType
from salve_tpu_torch.device import DeviceLike, resolve_device
from salve_tpu_torch.stitching import shape as shape_utils
from salve_tpu_torch.stitching.cluster_stitching import FINAL_FIGURE, fill_fused_groups
from salve_tpu_torch.stitching.models import Point2d, Pose
from salve_tpu_torch.utils import plotting
from salve_tpu_torch.utils.io import read_json_file

logger = logging.getLogger(__name__)


def pose_from_sim2(S) -> Pose:
    """A Sim(2) pose as a stitching Pose record (deg, clockwise)."""
    theta = float(np.degrees(np.arctan2(S.rotation[1, 0], S.rotation[0, 0])))
    t = S.translation * S.scale
    # stitching's transform_xy_by_pose rotates CLOCKWISE by pose.rotation.
    return Pose(position=Point2d(x=t[0], y=t[1]), rotation=-theta)


def _poses_from_pose_graph(est_pose_graph) -> Dict[int, Pose]:
    """PoseGraph2d Sim(2) poses -> stitching Pose records (deg, clockwise)."""
    return {pano_id: pose_from_sim2(pano.global_Sim2_local) for pano_id, pano in est_pose_graph.nodes.items()}


def stitch_building_layouts(
    building_id: str,
    hnet_pred_dir: str,
    raw_dataset_dir: str,
    est_localization_fpath: str,
    output_dir: str,
    device: DeviceLike = None,
) -> Tuple[list, List[List[np.ndarray]]]:
    """Fuse a floor's localized layouts into final room shapes + floorplan.

    Writes `{output_dir}/fused/final.png` where matplotlib is installed, and
    returns (floor_shape_final, fused_polygons) of
    `shape.refine_predicted_shape`: per room group, each member's fused
    boundary, confidences and pose; and the fused global-frame rings.
    """
    dev = resolve_device(device)
    os.makedirs(output_dir, exist_ok=True)
    cluster_dir = os.path.join(output_dir, "fused")
    Path(cluster_dir).mkdir(exist_ok=True, parents=True)

    hnet_floor_predictions = hnet_prediction_loader.load_hnet_predictions(
        building_id=building_id,
        raw_dataset_dir=raw_dataset_dir,
        predictions_data_root=hnet_pred_dir,
    )
    est_pose_graph_corners = salve_sfm_result_loader.load_estimated_pose_graph(
        json_fpath=Path(est_localization_fpath),
        boundary_type=EstimatedBoundaryType.HNET_CORNERS,
        raw_dataset_dir=raw_dataset_dir,
        predictions_data_root=hnet_pred_dir,
    )
    floor_id = est_pose_graph_corners.floor_id
    floor_predictions = hnet_floor_predictions[floor_id]

    wall_confidences: Dict[int, np.ndarray] = {}
    predicted_shapes_raw: Dict[int, np.ndarray] = {}
    for pano_id in est_pose_graph_corners.nodes.keys():
        if pano_id not in floor_predictions:
            continue
        pred = floor_predictions[pano_id]
        predicted_shapes_raw[pano_id], wall_confidences[pano_id] = (
            shape_utils.generate_dense_shape(
                v_vals=pred.floor_boundary,
                uncertainty=list(pred.floor_boundary_uncertainty),
            )
        )

    groups = room_merging_algo.group_panos_by_room(est_pose_graph_corners, device=dev)
    groups = [
        [p for p in g if p in predicted_shapes_raw] for g in groups
    ]
    groups = [g for g in groups if g]
    logger.info("Room groups: %s", groups)

    location_panos = _poses_from_pose_graph(est_pose_graph_corners)

    logger.info("Running shape refinement ...")
    floor_shape_final, fused_polygons = shape_utils.refine_predicted_shape(
        groups=groups,
        predicted_shapes=predicted_shapes_raw,
        wall_confidences=wall_confidences,
        location_panos=location_panos,
        cluster_dir=cluster_dir,
        tour_dir=output_dir,
    )
    if plotting.draw_side_figure(FINAL_FIGURE):
        _render_fused_floorplan(floor_shape_final, os.path.join(cluster_dir, "final.png"))
    return floor_shape_final, fused_polygons


def _render_fused_floorplan(floor_shape_final, save_fpath: str) -> None:
    """The fused rooms, filled in Tango colours (salve_tpu/cli/stitch_floor_plan.py:98-118)."""
    Figure = plotting.figure_class("the stitched floorplan")

    fig = Figure()
    axis = fig.add_subplot(1, 1, 1)
    fill_fused_groups(axis, floor_shape_final)
    axis.set_aspect("equal")
    fig.savefig(save_fpath, dpi=300)
    logger.info("Saved fused floorplan to %s", save_fpath)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Stitch a floorplan from previously localized poses.")
    p.add_argument("--raw_dataset_dir", type=existing_path, required=True,
                   help="Where ZInD dataset is stored on disk.")
    p.add_argument("--est-localization-fpath", dest="est_localization_fpath", type=existing_path, required=True,
                   help="Path to pose JSON generated by run_sfm (plot_save_dir_serialized/*.json).")
    p.add_argument("-o", "--output-dir", dest="output_dir", type=str, required=True)
    p.add_argument("--hnet-pred-dir", dest="hnet_pred_dir", type=existing_path, required=True,
                   help="Directory with HorizonNet room-shape and D/W/O predictions.")
    p.add_argument("--building_id", type=str, default=None,
                   help="ZInD building ID (default: parsed from the localization file).")
    p.add_argument("--device", type=str, default="cuda",
                   help="Where the room-grouping raster runs ('cuda' or 'cpu'; default: cuda).")
    return p


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    building_id = args.building_id
    if building_id is None:
        building_id = read_json_file(args.est_localization_fpath)["building_id"]
    floor_shape_final, _ = stitch_building_layouts(
        building_id=building_id,
        hnet_pred_dir=args.hnet_pred_dir,
        raw_dataset_dir=args.raw_dataset_dir,
        est_localization_fpath=args.est_localization_fpath,
        output_dir=args.output_dir,
        device=args.device,
    )
    logger.info("Fused %d room groups", len(floor_shape_final))


if __name__ == "__main__":
    main()
