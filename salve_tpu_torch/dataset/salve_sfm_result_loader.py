"""Load estimated pose-graph JSON (run_sfm output) back into a PoseGraph2d.

Parity: salve/dataset/salve_sfm_result_loader.py:29 — optionally merges in
MHNet dense-boundary or corner layouts for downstream stitching.

A copy of salve_tpu/dataset/salve_sfm_result_loader.py (no JAX), on the
port's numpy `pixel_to_worldmetric` (the reference's
`convert_points_px_to_worldmetric` is the same function).
"""

from __future__ import annotations

from enum import Enum, unique
from pathlib import Path
from typing import Optional

import numpy as np

from salve_tpu_torch.common.pano_data import PanoData
from salve_tpu_torch.common.posegraph2d import PoseGraph2d
from salve_tpu_torch.dataset import hnet_prediction_loader
from salve_tpu_torch.geometry.pano_projection import pixel_to_worldmetric
from salve_tpu_torch.geometry.sim2 import Sim2
from salve_tpu_torch.utils.io import read_json_file

IMAGE_HEIGHT_PX = 512
IMAGE_WIDTH_PX = 1024


@unique
class EstimatedBoundaryType(str, Enum):
    """Boundary representation for the loaded layouts."""

    NONE = "NONE"
    HNET_CORNERS = "HNET_CORNERS"
    HNET_DENSE = "HNET_DENSE"


def load_estimated_pose_graph(
    json_fpath: Path,
    boundary_type: EstimatedBoundaryType = EstimatedBoundaryType.NONE,
    raw_dataset_dir: Optional[str] = None,
    predictions_data_root: Optional[str] = None,
) -> PoseGraph2d:
    """Load the serialized wSi_dict pose graph, optionally with layouts."""
    if not isinstance(json_fpath, Path):
        raise ValueError("`json_fpath` arg must be a pathlib.Path object.")
    if not json_fpath.exists():
        raise FileNotFoundError(f"File not found at {json_fpath}")
    localization_data = read_json_file(json_fpath)

    building_id = localization_data["building_id"]
    floor_id = localization_data["floor_id"]

    hnet_floor_predictions = None
    if boundary_type in (EstimatedBoundaryType.HNET_CORNERS, EstimatedBoundaryType.HNET_DENSE):
        preds = hnet_prediction_loader.load_hnet_predictions(
            building_id=building_id,
            raw_dataset_dir=raw_dataset_dir,
            predictions_data_root=predictions_data_root,
        )
        if floor_id not in preds:
            raise ValueError(
                f"Predictions missing for {floor_id} of ZInD building {building_id}."
            )
        hnet_floor_predictions = preds[floor_id]

    nodes = {}
    for pano_id_str, wSi in localization_data["wSi_dict"].items():
        pano_id = int(pano_id_str)
        room_vertices_local_2d = np.zeros((0, 2))

        if hnet_floor_predictions is not None and pano_id in hnet_floor_predictions:
            if boundary_type == EstimatedBoundaryType.HNET_DENSE:
                u = np.arange(IMAGE_WIDTH_PX)
                v = np.round(hnet_floor_predictions[pano_id].floor_boundary)
                room_vertices_uv = np.hstack([u.reshape(-1, 1), v.reshape(-1, 1)])
            else:  # HNET_CORNERS
                uv = np.array(hnet_floor_predictions[pano_id].corners_in_uv, copy=True)
                uv[:, 0] *= IMAGE_WIDTH_PX
                uv[:, 1] *= IMAGE_HEIGHT_PX
                room_vertices_uv = uv[1::2]  # floor corners

            camera_height_m = 1.0
            layout_pts = pixel_to_worldmetric(
                points_px=room_vertices_uv,
                image_width=IMAGE_WIDTH_PX,
                camera_height_m=camera_height_m,
            )
            # Floor-plane coordinates are the first two columns of our
            # world-metric convention (vertical is column 2) — the same
            # slice mhnet_prediction.convert_to_pano_data uses, keeping
            # loader-produced layouts in the identical frame. (The
            # reference's [0, 2] pick belongs to its own column layout and
            # sits in its WIP stitching path.)
            room_vertices_local_2d = layout_pts[:, :2]

        nodes[pano_id] = PanoData(
            id=pano_id,
            global_Sim2_local=Sim2(
                np.array(wSi["R"]), t=np.array(wSi["t"]), s=wSi["s"]
            ),
            room_vertices_local_2d=room_vertices_local_2d,
            image_path=None,
            label=None,
            doors=None,
            windows=None,
            openings=None,
            vanishing_angle_deg=None,
        )

    return PoseGraph2d(
        building_id=building_id,
        floor_id=floor_id,
        nodes=nodes,
        scale_meters_per_coordinate=localization_data["scale_meters_per_coordinate"],
    )
