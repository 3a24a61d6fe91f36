"""Seeded OpenSfM and OpenMVG reconstructions of procedural floors.

OpenSfM and OpenMVG are not installed here, and no real reconstruction is in
the repository. This module writes the files their runs would leave
(`cli/execute_opensfm.py`, `cli/execute_openmvg.py`), made from a floor's GT
poses (`common/posegraph2d.py:get_gt_pose_graph` on a procedural building),
so that the parsers, the RANSAC Sim(3) alignment and the report all do real
work on them:

  * `results_dir/ZinD_{building}_{floor}__opensfm/reconstruction.json`: a
    list of two reconstructions, the main one and a second component made
    of some of the panos the main one lacks, each under its own Sim(3);
    cameras as OpenSfM writes them (`cTw`: an axis-angle `rotation` and a
    `translation`), a few seeded points with colours;
  * `results_dir/ZinD_{building}_{floor}__openmvg/reconstruction/sfm_data.json`
    (version 0.3): a view for every pano, extrinsics (the `rotation` of
    `cTw` and the camera `center`) for the localized ones.

Each algorithm draws from `np.random.default_rng([seed, k])` (k = 0 for
OpenSfM, 1 for OpenMVG):
  * a Sim(3) from the GT frame to the reconstruction's: a rotation about +z
    (the evaluation's alignment is planar), a translation in 3D and a scale;
  * per pano, noise on the heading (`rot_noise_deg`, degrees) and on the
    position (`trans_noise_m`, metres, through the floor's scale);
  * `num_dropped` panos left out of the main reconstruction.
The poses are then moved from the ZInD camera to the algorithm's
(`baselines/sfm_eval.py:get_{opensfm,openmvg}_T_zillow`, whose inverse
`measure_algorithm_localization_accuracy` applies) and written in the
algorithm's own convention.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

import numpy as np
from scipy.spatial.transform import Rotation

from salve_tpu_torch.baselines.sfm_eval import get_openmvg_T_zillow, get_opensfm_T_zillow
from salve_tpu_torch.common.posegraph2d import get_gt_pose_graph
from salve_tpu_torch.geometry.poses import Pose3

ROT_NOISE_DEG = 1.0
TRANS_NOISE_M = 0.05
NUM_DROPPED = 3
NUM_POINTS = 32
# The OpenSfM camera key of a 1024 x 512 equirectangular pano.
OPENSFM_CAMERA = "v2 unknown unknown 1024 512 spherical 0"


def _rot_z(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _random_sim3(rng: np.random.Generator):
    """(R, t, s): a rotation about +z, a 3D translation and a scale."""
    return _rot_z(rng.uniform(-np.pi, np.pi)), rng.uniform(-5.0, 5.0, 3), float(rng.uniform(0.5, 2.0))


def _algorithm_poses(
    gt_poses: Dict[int, Pose3],
    ids: List[int],
    rng: np.random.Generator,
    scale_m: float,
    rot_noise_deg: float,
    trans_noise_m: float,
    algocam_T_zillowcam: Pose3,
) -> Dict[int, Pose3]:
    """wTc of the algorithm's camera for `ids`: noisy GT poses under one
    seeded Sim(3), moved to the algorithm's camera."""
    R, t, s = _random_sim3(rng)
    zillowcam_T_algocam = algocam_T_zillowcam.inverse()
    out = {}
    for i in ids:
        aTi = gt_poses[i]
        dtheta = np.deg2rad(rng.normal(0.0, rot_noise_deg))
        dxy = rng.normal(0.0, trans_noise_m / scale_m, 2)
        noisy = Pose3(_rot_z(dtheta) @ aTi.R, aTi.t + np.array([dxy[0], dxy[1], 0.0]))
        bTi = Pose3(R @ noisy.R, s * (R @ noisy.t) + t)
        out[i] = bTi.compose(zillowcam_T_algocam)
    return out


def _floor_inputs(raw_dataset_dir: str, building_id: str, floor_id: str):
    gt = get_gt_pose_graph(building_id, floor_id, raw_dataset_dir)
    gt_poses = {i: p for i, p in enumerate(gt.as_3d_pose_graph()) if p is not None}
    names = {i: Path(pano.image_path).name for i, pano in gt.nodes.items()}
    return gt, gt_poses, names


def write_opensfm_reconstruction(
    results_dir: str,
    raw_dataset_dir: str,
    building_id: str,
    floor_id: str,
    seed: int,
    rot_noise_deg: float = ROT_NOISE_DEG,
    trans_noise_m: float = TRANS_NOISE_M,
    num_dropped: int = NUM_DROPPED,
) -> Path:
    """Write OpenSfM's reconstruction.json for one floor; returns its path."""
    rng = np.random.default_rng([seed, 0])
    gt, gt_poses, names = _floor_inputs(raw_dataset_dir, building_id, floor_id)
    ids = sorted(gt_poses)
    dropped = sorted(rng.choice(ids, size=num_dropped, replace=False).tolist())
    components = [[i for i in ids if i not in dropped], dropped[:2]]
    recons = []
    for members in components:
        wTc = _algorithm_poses(gt_poses, members, rng, gt.scale_meters_per_coordinate, rot_noise_deg,
                               trans_noise_m, get_opensfm_T_zillow())
        shots = {}
        for i, pose in wTc.items():
            cTw = pose.inverse()
            # scipy's rotation vector stays exact near a half turn, where
            # rotations3d.matrix_to_axis_angle divides by sin(angle).
            shots[names[i]] = {"rotation": Rotation.from_matrix(cTw.R).as_rotvec().tolist(),
                               "translation": cTw.t.tolist(), "camera": OPENSFM_CAMERA}
        centers = np.array([p.t for p in wTc.values()])
        points = {
            str(k): {"coordinates": (centers[k % len(centers)] + rng.normal(0.0, 1.0, 3)).tolist(),
                     "color": rng.integers(0, 256, 3).tolist()}
            for k in range(NUM_POINTS)
        }
        recons.append({
            "cameras": {OPENSFM_CAMERA: {"projection_type": "spherical", "width": 1024, "height": 512}},
            "shots": shots,
            "points": points,
        })
    out = Path(results_dir) / f"ZinD_{building_id}_{floor_id}__opensfm" / "reconstruction.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(recons))
    return out


def write_openmvg_reconstruction(
    results_dir: str,
    raw_dataset_dir: str,
    building_id: str,
    floor_id: str,
    seed: int,
    rot_noise_deg: float = ROT_NOISE_DEG,
    trans_noise_m: float = TRANS_NOISE_M,
    num_dropped: int = NUM_DROPPED,
) -> Path:
    """Write OpenMVG's sfm_data.json (v0.3) for one floor; returns its path."""
    rng = np.random.default_rng([seed, 1])
    gt, gt_poses, names = _floor_inputs(raw_dataset_dir, building_id, floor_id)
    ids = sorted(gt_poses)
    dropped = set(rng.choice(ids, size=num_dropped, replace=False).tolist())
    wTc = _algorithm_poses(gt_poses, [i for i in ids if i not in dropped], rng, gt.scale_meters_per_coordinate,
                           rot_noise_deg, trans_noise_m, get_openmvg_T_zillow())
    views = [
        {"key": k, "value": {"polymorphic_id": 1073741824, "ptr_wrapper": {"id": 2147483649 + k, "data": {
            "local_path": "", "filename": names[i], "width": 1024, "height": 512,
            "id_view": k, "id_intrinsic": 0, "id_pose": k}}}}
        for k, i in enumerate(ids)
    ]
    extrinsics = [
        # OpenMVG keeps cTw's rotation and the camera's centre.
        {"key": k, "value": {"rotation": wTc[i].R.T.tolist(), "center": wTc[i].t.tolist()}}
        for k, i in enumerate(ids) if i in wTc
    ]
    data = {"sfm_data_version": "0.3", "root_path": "images", "views": views, "intrinsics": [],
            "extrinsics": extrinsics, "structure": [], "control_points": []}
    out = Path(results_dir) / f"ZinD_{building_id}_{floor_id}__openmvg" / "reconstruction" / "sfm_data.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(data))
    return out
