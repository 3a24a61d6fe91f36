"""Load OpenMVG sfm_data.json results (parity: salve/baselines/openmvg.py).

A copy of salve_tpu/baselines/openmvg.py (no JAX).
"""

from __future__ import annotations

import glob
from pathlib import Path
from typing import List, Tuple

import numpy as np

from salve_tpu_torch.baselines.sfm_reconstruction import SfmReconstruction
from salve_tpu_torch.geometry.poses import Pose3
from salve_tpu_torch.utils.io import read_json_file


def panoid_from_key(key: str) -> int:
    """'floor_01_partial_room_01_pano_11.jpg' -> 11."""
    return int(Path(key).stem.split("_")[-1])


def load_openmvg_reconstructions_from_json(
    json_fpath: str, building_id: str, floor_id: str
) -> List[SfmReconstruction]:
    """OpenMVG sfm_data.json (v0.3) -> [SfmReconstruction].

    OpenMVG stores (R, center): t = -R @ center gives extrinsics cTw;
    poses are inverted to wTc (OpenMVG stores a camera's centre, not cTw's translation).
    """
    data = read_json_file(json_fpath)
    assert data["sfm_data_version"] == "0.3"

    key_to_fname_dict = {}
    for view in data["views"]:
        key_to_fname_dict[view["key"]] = view["value"]["ptr_wrapper"]["data"]["filename"]

    pose_dict = {}
    for ext_info in data["extrinsics"]:
        R = np.array(ext_info["value"]["rotation"])
        t = -R @ np.array(ext_info["value"]["center"])
        wTc = Pose3(R, t).inverse()
        pano_id = panoid_from_key(key_to_fname_dict[ext_info["key"]])
        pose_dict[pano_id] = wTc

    reconstruction = SfmReconstruction(
        camera=None,
        pose_dict=pose_dict,
        points=np.zeros((0, 3)),
        rgb=np.zeros((0, 3), dtype=np.uint8),
    )
    # OpenMVG incremental returns only the largest connected component.
    return [reconstruction]


def find_seed_pair(image_dirpath: str) -> Tuple[str, str]:
    """Two capture-order-adjacent panos as the incremental-SfM seed pair."""
    image_fpaths = glob.glob(f"{image_dirpath}/*.jpg")
    if len(image_fpaths) < 2:
        raise ValueError(
            "Less than two images found in the image directory, so no seed can be assigned."
        )
    image_fpaths.sort(key=panoid_from_key)
    frame_idxs = np.array([panoid_from_key(x) for x in image_fpaths])
    temporal_dist = np.diff(frame_idxs)
    valid_seed_idxs = np.where(np.absolute(temporal_dist) == 1)[0]
    seed_idx_1 = valid_seed_idxs[0]
    return Path(image_fpaths[seed_idx_1]).name, Path(image_fpaths[seed_idx_1 + 1]).name
