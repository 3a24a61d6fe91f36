"""Floor-level reconstruction quality report.

Port of salve_tpu/common/floor_reconstruction_report.py (parity:
salve/common/floor_reconstruction_report.py): Sim(3)-align the estimated
pose graph to GT (the batched RANSAC on `device`), measure per-pano pose
errors and % localized, rasterize the room layouts on `device` with the
port's `polygon_mask` for the floorplan IoU (0.1 m/px over +/-25 m), and
serialize the aligned global poses. `device=None` is the CUDA card.

With `plot_save_dir` set, the report also draws salve_tpu's two figures, the
side-by-side floorplans and the IoU masks. They are side figures
(`utils/plotting.py`, rule (b)): without matplotlib they are left out, with
one warning a process, and everything else is written as with them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from salve_tpu_torch.common.posegraph2d import PoseGraph2d
from salve_tpu_torch.device import DeviceLike, resolve_device
from salve_tpu_torch.ops.raster import polygon_mask
from salve_tpu_torch.utils import plotting
from salve_tpu_torch.utils.io import save_json_file
from salve_tpu_torch.utils.iou_utils import binary_mask_iou

# IoU raster spec (floor_reconstruction_report.py:271-296).
BUILDING_XLIMS_M = 25
BUILDING_YLIMS_M = 25
IOU_EVAL_METERS_PER_PX = 0.1
# The report's figures, as its rule-(b) warning names them.
REPORT_FIGURES = "the floor report's side-by-side floorplan and IoU mask figures"
# Rooms rasterized in one polygon_mask call: its (rooms, H, W, V) bool
# intermediates take about 4 MB a room at 501^2 px and 16 vertices.
ROOMS_PER_CHUNK = 16


@dataclass
class FloorReconstructionReport:
    """Summary statistics for one reconstructed floor."""

    avg_abs_rot_err: float
    avg_abs_trans_err: float
    percent_panos_localized: float
    floorplan_iou: Optional[float] = np.nan
    rotation_errors: Optional[np.ndarray] = None
    translation_errors: Optional[np.ndarray] = None
    # The paper's completeness metric (index.html:246 — 81% / 89% of panos
    # localized within the first 2 / 3 connected components on the test
    # split): fraction of the floor's panos inside the top-k components of
    # the high-confidence edge graph. Filled by cli/run_sfm.py.
    percent_in_top2_ccs: float = np.nan
    percent_in_top3_ccs: float = np.nan
    # Which floor this report scores.
    building_id: Optional[str] = None
    floor_id: Optional[str] = None

    def __repr__(self) -> str:
        return (
            f"Abs. Rot err (deg) {self.avg_abs_rot_err:.1f}, "
            f"Abs. trans err {self.avg_abs_trans_err:.2f}, "
            f"%Localized {self.percent_panos_localized:.2f},"
            f"Floorplan IoU {self.floorplan_iou:.2f}"
        )

    @classmethod
    def from_est_floor_pose_graph(
        cls,
        est_floor_pose_graph: PoseGraph2d,
        gt_floor_pose_graph: PoseGraph2d,
        plot_save_dir: Optional[str] = None,
        plot_save_fpath: Optional[str] = None,
        raw_dataset_dir: Optional[str] = None,
        device: DeviceLike = None,
    ) -> "FloorReconstructionReport":
        """Align to GT, measure errors, rasterize IoU, serialize poses; with
        `plot_save_dir`, also draw the two figures where matplotlib is
        installed. `raw_dataset_dir` is unused, as in salve_tpu."""
        dev = resolve_device(device)
        num_localized = len(est_floor_pose_graph.nodes)
        num_floor_panos = len(gt_floor_pose_graph.nodes)
        percent_panos_localized = num_localized / num_floor_panos * 100

        aligned_est, _ = est_floor_pose_graph.align_by_Sim3_to_ref_pose_graph(
            ref_pose_graph=gt_floor_pose_graph, device=dev
        )
        (
            mean_abs_rot_err,
            mean_abs_trans_err,
            rot_errors,
            trans_errors,
        ) = aligned_est.measure_aligned_abs_pose_error(gt_floor_pg=gt_floor_pose_graph)

        # Convert translation error units to meters.
        scale = gt_floor_pose_graph.scale_meters_per_coordinate
        mean_abs_trans_err_m = scale * mean_abs_trans_err

        draw = plot_save_dir is not None and plotting.draw_side_figure(REPORT_FIGURES)
        if plot_save_dir is not None:
            serialize_predicted_pose_graph(aligned_est, gt_floor_pose_graph, plot_save_dir)
        if draw:
            render_floorplans_side_by_side(
                est_floor_pose_graph=aligned_est,
                show_plot=False,
                save_plot=True,
                plot_save_dir=plot_save_dir,
                gt_floor_pg=gt_floor_pose_graph,
                plot_save_fpath=plot_save_fpath,
            )

        floorplan_iou = render_raster_occupancy(
            est_floor_pose_graph=aligned_est,
            gt_floor_pg=gt_floor_pose_graph,
            plot_save_dir=plot_save_dir,
            save_viz=draw,
            device=dev,
        )

        return cls(
            avg_abs_rot_err=float(mean_abs_rot_err),
            avg_abs_trans_err=float(mean_abs_trans_err_m),
            percent_panos_localized=float(percent_panos_localized),
            floorplan_iou=float(floorplan_iou),
            rotation_errors=rot_errors,
            translation_errors=trans_errors,
            building_id=gt_floor_pose_graph.building_id,
            floor_id=gt_floor_pose_graph.floor_id,
        )


def serialize_predicted_pose_graph(
    aligned_est_floor_pose_graph: PoseGraph2d,
    gt_floor_pose_graph: PoseGraph2d,
    plot_save_dir: str,
) -> None:
    """Save Sim(2) global poses as (R,t,s) JSON (parity :191-217)."""
    building_id = gt_floor_pose_graph.building_id
    floor_id = gt_floor_pose_graph.floor_id
    global_poses_info = {}
    for i, pano_data in aligned_est_floor_pose_graph.nodes.items():
        S = pano_data.global_Sim2_local
        global_poses_info[i] = {
            "R": S.rotation.tolist(),
            "t": S.translation.tolist(),
            "s": S.scale,
        }
    save_dict = {
        "building_id": building_id,
        "floor_id": floor_id,
        "scale_meters_per_coordinate": gt_floor_pose_graph.scale_meters_per_coordinate,
        "wSi_dict": global_poses_info,
    }
    save_json_file(
        f"{plot_save_dir}_serialized/{building_id}__{floor_id}.json", save_dict
    )


def rasterize_room(
    floor_pose_graph: PoseGraph2d,
    scale_meters_per_coordinate: float,
    img_px: int,
    meters_per_px: float,
    device: DeviceLike = None,
) -> np.ndarray:
    """Occupancy mask: union of all global room polygons, rasterized on `device`.

    The float32 image-space vertices are made as the JAX package makes them
    (float64 numpy arithmetic, then a float32 cast), padded to at least 64.
    """
    dev = resolve_device(device)
    half_m = (img_px / 2) * meters_per_px
    polys = []
    for _, pano_obj in floor_pose_graph.nodes.items():
        verts_m = pano_obj.room_vertices_global_2d * scale_meters_per_coordinate
        polys.append((verts_m + half_m) / meters_per_px)
    occ = torch.zeros((img_px + 1, img_px + 1), dtype=torch.bool, device=dev)
    width = max([64] + [p.shape[0] for p in polys])
    for start in range(0, len(polys), ROOMS_PER_CHUNK):
        chunk = polys[start : start + ROOMS_PER_CHUNK]
        v = np.zeros((len(chunk), width, 2), dtype=np.float32)
        for k, img_xy in enumerate(chunk):
            v[k, : img_xy.shape[0]] = img_xy
        counts = np.array([p.shape[0] for p in chunk], dtype=np.int64)
        masks = polygon_mask(torch.as_tensor(v, device=dev), counts, img_px + 1, img_px + 1)
        occ |= masks.any(dim=0)
    return occ.cpu().numpy()


def render_raster_occupancy(
    est_floor_pose_graph: PoseGraph2d,
    gt_floor_pg: PoseGraph2d,
    plot_save_dir: Optional[str] = None,
    save_viz: bool = False,
    device: DeviceLike = None,
) -> float:
    """Raster floorplan IoU @ 0.1 m/px over +/-25 m (parity :271); with
    `save_viz` and `plot_save_dir`, the two masks are drawn to
    `{plot_save_dir}__floorplan_iou/{building}_{floor}.jpg`."""
    scale = gt_floor_pg.scale_meters_per_coordinate
    img_px = int(2 * BUILDING_XLIMS_M / IOU_EVAL_METERS_PER_PX)

    est_mask = rasterize_room(est_floor_pose_graph, scale, img_px, IOU_EVAL_METERS_PER_PX, device)
    gt_mask = rasterize_room(gt_floor_pg, scale, img_px, IOU_EVAL_METERS_PER_PX, device)
    iou = binary_mask_iou(est_mask, gt_mask)

    if save_viz and plot_save_dir is not None:
        plt = plotting.pyplot("the IoU mask figure")
        plt.subplot(1, 2, 1)
        plt.imshow(np.flipud(est_mask))
        plt.subplot(1, 2, 2)
        plt.imshow(np.flipud(gt_mask))
        plt.suptitle(f"{gt_floor_pg.building_id} {gt_floor_pg.floor_id} --> IoU {iou:.2f}")
        save_dir = f"{plot_save_dir}__floorplan_iou"
        os.makedirs(save_dir, exist_ok=True)
        plt.savefig(
            f"{save_dir}/{gt_floor_pg.building_id}_{gt_floor_pg.floor_id}.jpg", dpi=300
        )
        plt.close("all")
    return iou


def render_floorplans_side_by_side(
    est_floor_pose_graph: PoseGraph2d,
    show_plot: bool = False,
    save_plot: bool = True,
    plot_save_dir: str = "floorplan_renderings",
    gt_floor_pg: Optional[PoseGraph2d] = None,
    plot_save_fpath: Optional[str] = None,
) -> None:
    """GT vs estimated floorplan, rendered side by side to a JPG."""
    plt = plotting.pyplot("render_floorplans_side_by_side")

    building_id = est_floor_pose_graph.building_id
    floor_id = est_floor_pose_graph.floor_id
    scale = (
        gt_floor_pg.scale_meters_per_coordinate if gt_floor_pg is not None else 1.0
    )

    plt.figure(figsize=(12, 6))
    ax1 = None
    if gt_floor_pg is not None:
        plt.suptitle("left: GT floorplan. Right: estimated floorplan.")
        ax1 = plt.subplot(1, 2, 1)
        _render_floorplan(gt_floor_pg, scale)
        ax1.set_aspect("equal")
    ax2 = plt.subplot(1, 2, 2, sharex=ax1, sharey=ax1)
    ax2.set_aspect("equal")
    _render_floorplan(est_floor_pose_graph, scale)
    plt.title(f"Building {building_id}, {floor_id}")

    if save_plot:
        if plot_save_fpath is None:
            os.makedirs(plot_save_dir, exist_ok=True)
            plot_save_fpath = f"{plot_save_dir}/{building_id}_{floor_id}.jpg"
        plt.savefig(plot_save_fpath, dpi=300)
    plt.close("all")


def _render_floorplan(pose_graph: PoseGraph2d, scale: float) -> None:
    """Each room's ring and its pano's centre, into the current axes."""
    plt = plotting.pyplot("_render_floorplan", agg=False)

    for _, pano_obj in pose_graph.nodes.items():
        verts = pano_obj.room_vertices_global_2d * scale
        verts = np.vstack([verts, verts[:1]])
        plt.plot(verts[:, 0], verts[:, 1], linewidth=1)
        center = pano_obj.global_Sim2_local.translation * scale
        plt.scatter(center[0], center[1], s=6)


def summarize_reports(reconstruction_reports: List[FloorReconstructionReport]) -> dict:
    """Mean + median of the four error metrics over all floors (parity :353)."""
    summary = {}
    if len(reconstruction_reports) == 0:
        return summary
    for error_metric in [
        "avg_abs_rot_err",
        "avg_abs_trans_err",
        "percent_panos_localized",
        "floorplan_iou",
        "percent_in_top2_ccs",
        "percent_in_top3_ccs",
    ]:
        vals = [getattr(r, error_metric) for r in reconstruction_reports]
        summary[f"mean_{error_metric}"] = float(np.nanmean(vals))
        summary[f"median_{error_metric}"] = float(np.nanmedian(vals))
    return summary


def compute_translation_errors_against_threshold(
    reconstruction_reports: List[FloorReconstructionReport], threshold: float
) -> float:
    """Avg fraction of cameras under a translation-error threshold."""
    rates = [
        float((r.translation_errors < threshold).mean())
        for r in reconstruction_reports
        if r.translation_errors is not None and len(r.translation_errors)
    ]
    return float(np.mean(rates)) if rates else float("nan")
