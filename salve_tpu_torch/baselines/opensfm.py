"""Load OpenSfM reconstruction.json results (parity: salve/baselines/opensfm.py).

OpenSfM stores extrinsics cTw as axis-angle + translation; poses are
inverted to wTc on load. GTSAM Rot3.AxisAngle becomes a NumPy Rodrigues
formula.

A copy of salve_tpu/baselines/opensfm.py (no JAX).
"""

from __future__ import annotations

import logging
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Dict, List, Tuple

import numpy as np

from salve_tpu_torch.baselines.sfm_reconstruction import SfmReconstruction
from salve_tpu_torch.geometry.poses import Pose3
from salve_tpu_torch.geometry.rotations3d import axis_angle_to_matrix
from salve_tpu_torch.utils.io import read_json_file

logger = logging.getLogger(__name__)


def panoid_from_key(key: str) -> int:
    """'floor_01_partial_room_01_pano_11.jpg' -> 11."""
    return int(Path(key).stem.split("_")[-1])


def point_from_json(key: str, obj: Dict[str, Any]) -> Tuple[Any, Any]:
    return obj["coordinates"], obj["color"]


def pose_from_json(obj: Dict[str, Any]) -> Pose3:
    """OpenSfM extrinsics (cTw, axis-angle) -> wTc pose."""
    R = axis_angle_to_matrix(np.array(obj["rotation"]))
    t = np.array(obj.get("translation", np.zeros(3)))
    cTw = Pose3(R, t)
    return cTw.inverse()


def shot_in_reconstruction_from_json(
    key: str, obj: Dict[str, Any], is_pano_shot: bool = False
) -> Pose3:
    return pose_from_json(obj)


def camera_from_json(key: str, obj: Dict[str, Any]) -> SimpleNamespace:
    pt = obj.get("projection_type", "perspective")
    if pt in ("spherical", "equirectangular"):
        camera = SimpleNamespace(
            projection_type="SPHERICAL", id=None, width=None, height=None
        )
    elif pt == "perspective":
        f = obj["focal"] * max(obj["width"], obj["height"])
        camera = SimpleNamespace(
            projection_type=pt, width=obj["width"], height=obj["height"], focal=f
        )
    else:
        raise NotImplementedError(f"Unsupported projection type {pt}")
    camera.id = key
    camera.width = int(obj.get("width", 0) or 0)
    camera.height = int(obj.get("height", 0) or 0)
    return camera


def load_opensfm_reconstruction_from_json(obj: Dict[str, Any]) -> SfmReconstruction:
    """One OpenSfM reconstruction JSON object -> SfmReconstruction."""
    camera = None
    for key, value in obj["cameras"].items():
        camera = camera_from_json(key, value)

    pose_dict = {}
    for key, value in obj["shots"].items():
        pose_dict[panoid_from_key(key)] = shot_in_reconstruction_from_json(key, value)

    points = np.zeros((0, 3))
    rgb = np.zeros((0, 3), dtype=np.uint8)
    if "points" in obj:
        pts, colors = [], []
        for key, value in obj["points"].items():
            point, color = point_from_json(key, value)
            pts.append(point)
            colors.append(color)
        if pts:
            points = np.array(pts)
            rgb = np.array(colors).astype(np.uint8)

    logger.info(
        "Reconstruction found with %d cameras and %d points", len(pose_dict), points.shape[0]
    )
    return SfmReconstruction(camera, pose_dict, points, rgb)


def load_opensfm_reconstructions_from_json(
    reconstruction_json_fpath: str,
) -> List[SfmReconstruction]:
    """All connected components from an OpenSfM reconstruction.json."""
    if not Path(reconstruction_json_fpath).exists():
        return []
    objs = read_json_file(reconstruction_json_fpath)
    return [load_opensfm_reconstruction_from_json(obj) for obj in objs]
