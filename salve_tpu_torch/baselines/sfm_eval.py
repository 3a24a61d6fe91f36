"""Evaluate third-party SfM reconstructions against ZInD GT poses.

Parity: salve/baselines/sfm_eval.py — coordinate-convention adapters for
OpenSfM/OpenMVG spherical cameras, robust Sim(3) alignment to GT, and the
standard FloorReconstructionReport metrics.

A copy of salve_tpu/baselines/sfm_eval.py (no JAX) whose floor evaluation
takes `device`: the RANSAC Sim(3) alignment and the report (its RANSAC and
raster IoU) run there. `device=None` is the CUDA card, and the call raises
without one before it reads a file.
"""

from __future__ import annotations

import glob
import logging
import os
from typing import List, Optional

import numpy as np

from salve_tpu_torch.algorithms.pose_alignment import ransac_align_poses_sim3_ignore_missing
from salve_tpu_torch.baselines import openmvg as openmvg_utils
from salve_tpu_torch.baselines import opensfm as opensfm_utils
from salve_tpu_torch.common import posegraph2d
from salve_tpu_torch.common.floor_reconstruction_report import FloorReconstructionReport
from salve_tpu_torch.common.posegraph3d import PoseGraph3d
from salve_tpu_torch.device import DeviceLike, resolve_device
from salve_tpu_torch.geometry.poses import Pose3
from salve_tpu_torch.geometry.rotations3d import rot3_rzryrx
from salve_tpu_torch.utils.io import save_json_file

logger = logging.getLogger(__name__)


def get_opensfm_T_zillow() -> Pose3:
    """OpenSfM spherical camera -> ZInD spherical camera (+y up vs +z up)."""
    return Pose3(rot3_rzryrx(np.pi / 2, 0.0, 0.0), np.zeros(3))


def get_openmvg_T_zillow() -> Pose3:
    """OpenMVG spherical camera -> ZInD spherical camera (+y up vs +z up)."""
    return Pose3(rot3_rzryrx(np.pi / 2, 0.0, 0.0), np.zeros(3))


def _empty_report() -> FloorReconstructionReport:
    return FloorReconstructionReport(
        avg_abs_rot_err=np.nan,
        avg_abs_trans_err=np.nan,
        percent_panos_localized=0,
        floorplan_iou=0.0,
    )


def save_empty_json_results_file(
    results_dir: str, building_id: str, floor_id: str, algorithm_name: str
) -> None:
    floor_results_dicts = [
        {
            "id": "Reconstruction 0",
            "num_cameras": 0,
            "num_points": 0,
            "mean_abs_rot_err": np.nan,
            "mean_abs_trans_err": np.nan,
        }
    ]
    save_json_file(f"{results_dir}/{building_id}_{floor_id}.json", floor_results_dicts)


def measure_algorithm_localization_accuracy(
    building_id: str,
    floor_id: str,
    raw_dataset_dir: str,
    algorithm_name: str,
    save_dir: str,
    reconstruction_json_fpath: str,
    visualize_3d: bool = False,
    device: DeviceLike = None,
) -> FloorReconstructionReport:
    """Report for a floor's reconstruction vs GT, via robust Sim(3) alignment.

    With visualize_3d, the GT + estimated 3D pose graphs are rendered before
    and after the Sim(3) alignment (parity: salve/baselines/sfm_eval.py:177,184,
    Open3D there) as PNGs under {save_dir}/viz_3d_poses; that branch needs
    matplotlib.
    """
    dev = resolve_device(device)
    if algorithm_name == "opensfm":
        reconstructions = opensfm_utils.load_opensfm_reconstructions_from_json(
            reconstruction_json_fpath
        )
    elif algorithm_name == "openmvg":
        reconstructions = openmvg_utils.load_openmvg_reconstructions_from_json(
            reconstruction_json_fpath, building_id, floor_id
        )
        if reconstructions and len(reconstructions[0].pose_dict) == 0:
            return _empty_report()
    else:
        raise ValueError(f"Unknown algorithm {algorithm_name}")

    if len(reconstructions) == 0:
        return _empty_report()

    gt_floor_pose_graph = posegraph2d.get_gt_pose_graph(
        building_id, floor_id, raw_dataset_dir
    )

    algocam_T_zillowcam = (
        get_opensfm_T_zillow() if algorithm_name == "opensfm" else get_openmvg_T_zillow()
    )

    floor_results_dicts = []
    report = _empty_report()
    # Use only the largest connected component (reconstruction 0).
    for r, reconstruction in enumerate(reconstructions[:1]):
        aTi_list_gt = gt_floor_pose_graph.as_3d_pose_graph()
        bTi_list_est: List[Optional[Pose3]] = [
            reconstruction.pose_dict.get(i, None) for i in range(len(aTi_list_gt))
        ]
        aTi_list_gt = [
            aTi if bTi_list_est[i] is not None else None
            for i, aTi in enumerate(aTi_list_gt)
        ]
        bTi_list_est = [
            bTi.compose(algocam_T_zillowcam) if bTi is not None else None
            for bTi in bTi_list_est
        ]

        if visualize_3d:
            from salve_tpu_torch.visualization.pose_viz import plot_3d_poses

            viz3d_dir = f"{save_dir}/viz_3d_poses"
            os.makedirs(viz3d_dir, exist_ok=True)
            plot_3d_poses(
                aTi_list_gt, bTi_list_est,
                save_fpath=f"{viz3d_dir}/{building_id}_{floor_id}_prealign.png",
                title=f"{building_id} {floor_id}: before Sim(3) alignment",
            )

        aligned_bTi_list_est, _ = ransac_align_poses_sim3_ignore_missing(
            aTi_list_gt, bTi_list_est, device=dev
        )

        if visualize_3d:
            plot_3d_poses(
                aTi_list_gt, aligned_bTi_list_est,
                save_fpath=f"{viz3d_dir}/{building_id}_{floor_id}_aligned.png",
                title=f"{building_id} {floor_id}: after Sim(3) alignment",
            )

        est_pg3 = PoseGraph3d.from_wTi_list(aligned_bTi_list_est, building_id, floor_id)
        est_floor_pose_graph = est_pg3.project_to_2d(gt_floor_pose_graph)

        viz_save_dir = f"{save_dir}/viz_largest_cc"
        os.makedirs(viz_save_dir, exist_ok=True)
        report = FloorReconstructionReport.from_est_floor_pose_graph(
            est_floor_pose_graph=est_floor_pose_graph,
            gt_floor_pose_graph=gt_floor_pose_graph,
            plot_save_dir=viz_save_dir,
            device=dev,
        )
        floor_results_dicts.append(
            {
                "id": f"Reconstruction {r}",
                "num_cameras": len(reconstruction.pose_dict),
                "num_points": reconstruction.points.shape[0],
                "mean_abs_rot_err": report.avg_abs_rot_err,
                "mean_abs_trans_err": report.avg_abs_trans_err,
            }
        )

    summary_save_dir = f"{save_dir}/result_summaries"
    os.makedirs(summary_save_dir, exist_ok=True)
    save_json_file(f"{summary_save_dir}/{building_id}_{floor_id}.json", floor_results_dicts)
    return report


def count_panos_on_floor(raw_dataset_dir: str, building_id: str, floor_id: str) -> int:
    return len(glob.glob(f"{raw_dataset_dir}/{building_id}/panos/{floor_id}_*.jpg"))


def analyze_algorithm_results(raw_dataset_dir: str, json_results_dir: str) -> dict:
    """Corpus-level completeness + accuracy summary over per-floor JSONs."""
    from salve_tpu_torch.utils.io import read_json_file

    rot_errs, trans_errs, num_cams = [], [], []
    for fpath in glob.glob(f"{json_results_dir}/*.json"):
        for rec in read_json_file(fpath):
            num_cams.append(rec["num_cameras"])
            if rec["num_cameras"] > 0:
                rot_errs.append(rec["mean_abs_rot_err"])
                trans_errs.append(rec["mean_abs_trans_err"])
    return {
        "num_floors": len(num_cams),
        "mean_num_cameras": float(np.mean(num_cams)) if num_cams else 0.0,
        "mean_abs_rot_err": float(np.nanmean(rot_errs)) if rot_errs else float("nan"),
        "mean_abs_trans_err": float(np.nanmean(trans_errs)) if trans_errs else float("nan"),
    }
