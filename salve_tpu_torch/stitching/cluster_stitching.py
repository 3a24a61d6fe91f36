"""Cluster-prediction stitching: fuse localized pano layouts, score vs GT.

Completes the reference's WIP ``scripts/stitch_floor_plan.py`` flow (live
``pdb.set_trace()`` at :73, undefined globals) as a working library
function: per cluster of localized panos ->
GT-anchored pose alignment (ground_truth_utils) -> MemoryLoader madori
predictions -> dense shapes + corner shapes -> room grouping ->
confidence-weighted fusion (shape.refine_predicted_shape) -> raster IoU vs
the GT floor map, serialized to ``score.json``.

A copy of salve_tpu/stitching/cluster_stitching.py (no JAX). Room grouping
and the raster IoU run on `device` (None: the CUDA card). Each cluster's
``final.png`` is a side figure (`utils/plotting.py`, rule (b)): without
matplotlib it is left out, with one warning a process, and ``score.json``
is written as with it.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any, Dict, List

import numpy as np

from salve_tpu_torch.device import DeviceLike, resolve_device
from salve_tpu_torch.stitching import shape as shape_utils
from salve_tpu_torch.stitching.floor_map import FloorMapObject
from salve_tpu_torch.stitching.ground_truth_utils import align_pred_poses_with_gt
from salve_tpu_torch.stitching.loaders import MemoryLoader
from salve_tpu_torch.stitching.draw import TANGO_COLOR_PALETTE, draw_shape_in_top_down_canvas_fill
from salve_tpu_torch.stitching.models import Point2d, Pose
from salve_tpu_torch.utils import plotting

logger = logging.getLogger(__name__)

# The stitched floorplan figure, as its rule-(b) warning names it (both
# stitching flows draw one).
FINAL_FIGURE = "the stitched floorplan final.png"


def stitch_clusters(
    est_localization_fpath: str,
    hnet_pred_dir: str,
    path_gt_floor_map: str,
    output_dir: str,
    render: bool = True,
    device: DeviceLike = None,
) -> List[Dict[str, Any]]:
    """Stitch every cluster in a localization JSON and score it against GT.

    Args:
        est_localization_fpath: cluster_pred.json — list of clusters, each
            ``{floor_id, scale, panos: {panoid: {pose}}, start_panoid}``.
        hnet_pred_dir: ``{pano_dir}/{panoid}/rmx-*_predictions.json`` tree.
        path_gt_floor_map: ZInD floor_map JSON (GT room/floor shapes).
        output_dir: where fused renders + score.json get written.
        render: draw each cluster's ``fused/cluster_{i}/final.png``.
        device: where the rasters run; None is the CUDA card.

    Returns:
        One score record per cluster: raster IoU of the fused floorplan vs
        (a) the GT rooms observed by the cluster's panos ("iou") and (b) the
        whole GT floor ("iou_all", the reference's ``iou1``
        scripts/stitch_floor_plan.py:228-233).
    """
    dev = resolve_device(device)
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)

    with open(path_gt_floor_map) as f:
        floor_map_gt = json.load(f)
    fmo = FloorMapObject(floor_map_gt)
    with open(est_localization_fpath) as f:
        localizations = json.load(f)

    loader = MemoryLoader(
        data_root=str(hnet_pred_dir),
        data_type={"rse": ["joint_madori_v1"], "dwo": ["rcnn"]},
    )

    all_scores: List[Dict[str, Any]] = []
    for i_cluster, item in enumerate(localizations):
        cluster_dir = out / "fused" / f"cluster_{i_cluster}"
        cluster_dir.mkdir(parents=True, exist_ok=True)

        aligned = align_pred_poses_with_gt(
            floor_map_gt_object=fmo, cluster=item
        )
        cluster = aligned["panos"]
        logger.info("cluster %d: %d localized panos", i_cluster, len(cluster))

        predicted_corner_shapes: Dict[str, np.ndarray] = {}
        predicted_shapes_raw: Dict[str, np.ndarray] = {}
        wall_confidences: Dict[str, Any] = {}
        location_panos: Dict[str, Pose] = {}
        for panoid, rec in cluster.items():
            pred = loader.get_room_shape_predictions(panoid, type="joint_madori_v1")
            if pred is None:
                continue
            room_shape = pred["room_shape"]
            if len(room_shape["corners_in_uv"]) < 3:
                continue
            predicted_shapes_raw[panoid], wall_confidences[panoid] = (
                shape_utils.generate_dense_shape(
                    v_vals=room_shape["raw_predictions"]["floor_boundary"],
                    uncertainty=room_shape["raw_predictions"][
                        "floor_boundary_uncertainty"
                    ],
                )
            )
            predicted_corner_shapes[panoid] = (
                shape_utils.load_room_shape_polygon_from_predictions(
                    room_shape_pred=room_shape["corners_in_uv"]
                )
            )
            pose_raw = rec["pose"]
            location_panos[panoid] = Pose(
                position=Point2d(x=pose_raw["x"], y=pose_raw["y"]),
                rotation=pose_raw["rotation"],
            )

        groups = shape_utils.group_panos_by_room(
            predicted_corner_shapes, location_panos, device=dev
        )
        logger.info("cluster %d: %d room groups", i_cluster, len(groups))

        floor_shape_final, fused_polygons = shape_utils.refine_predicted_shape(
            groups=groups,
            predicted_shapes=predicted_shapes_raw,
            wall_confidences=wall_confidences,
            location_panos=location_panos,
            cluster_dir=str(cluster_dir),
            tour_dir=str(out),
        )
        pred_rings = [ring for group in fused_polygons for ring in group]

        # GT rooms observed by this cluster's panos.
        rsids_cluster = {
            floor_map_gt["panos"][p]["room_shape_id"]
            for p in cluster
            if p in floor_map_gt["panos"]
        }
        gt_rings_cluster = [
            fmo.get_room_shape_global_ring(rsid) for rsid in sorted(rsids_cluster)
        ]
        score: Dict[str, Any] = {"i_cluster": i_cluster, "n_panos": len(cluster)}
        s = shape_utils.iou_between_polygon_sets(pred_rings, gt_rings_cluster, device=dev)
        score.update(
            iou=s["iou"],
            area_pred=s["area_a"],
            area_gt=s["area_b"],
            area_intersection=s["area_intersection"],
            area_union=s["area_union"],
        )

        # The whole GT floor (reference's iou1).
        floor_number = int(item["floor_id"].split("_")[-1])
        fsid = fmo.get_floor_shape_id_by_number(floor_number)
        if fsid is not None:
            rsids_floor = sorted(
                rsid
                for rsid, owner_fsid in fmo.fsids.items()
                if owner_fsid == fsid
            )
            gt_rings_floor = [
                fmo.get_room_shape_global_ring(rsid) for rsid in rsids_floor
            ]
            s1 = shape_utils.iou_between_polygon_sets(pred_rings, gt_rings_floor, device=dev)
            score.update(iou_all=s1["iou"], area_gt_all=s1["area_b"])
        all_scores.append(score)

        if render and plotting.draw_side_figure(FINAL_FIGURE):
            _render_cluster(
                floor_shape_final, gt_rings_cluster, cluster_dir / "final.png"
            )

    with open(out / "score.json", "w") as f:
        json.dump(all_scores, f, indent=2)
    return all_scores


def fill_fused_groups(axis, floor_shape_final) -> None:
    """Each room group's fused shapes, filled in its Tango colour (both
    stitching flows' figure)."""
    for i_group, group_shapes in enumerate(floor_shape_final):
        color = TANGO_COLOR_PALETTE[(((8 - i_group) % 8) * 3 + i_group // 8) % 24]
        color = (color[0] / 255, color[1] / 255, color[2] / 255)
        for xys_fused, _, pose0 in group_shapes:
            draw_shape_in_top_down_canvas_fill(axis, xys_fused, color, pose=pose0)


def _render_cluster(floor_shape_final, gt_rings, save_fpath) -> None:
    """Fused rooms (filled, Tango colors) next to the GT room outlines."""
    Figure = plotting.figure_class("_render_cluster")

    fig = Figure(figsize=(12, 6))
    axis = fig.add_subplot(1, 2, 1)
    fill_fused_groups(axis, floor_shape_final)
    axis.set_aspect("equal")
    axis.set_title("fused")
    gt_axis = fig.add_subplot(1, 2, 2, sharex=axis, sharey=axis)
    for ring in gt_rings:
        closed = np.vstack([ring, ring[:1]])
        gt_axis.plot(closed[:, 0], closed[:, 1], color="gray", linewidth=0.8)
    gt_axis.set_aspect("equal")
    gt_axis.set_title("GT rooms")
    fig.savefig(str(save_fpath), dpi=200)

