"""ModifiedHorizonNet (MHNet) prediction parsing.

MHNet is an external model whose weights were never released; its JSON
predictions on ZInD (the reference's horizon_net_schema.json) are the
pipeline input. Parity: salve/dataset/mhnet_prediction.py, including pano-seam
W/D/O merging and RDP layout simplification (epsilon 0.02 in room coords).

A copy of salve_tpu/dataset/mhnet_prediction.py (no JAX).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

import salve_tpu_torch.geometry.pano_projection as pano_projection
import salve_tpu_torch.utils.io as io_utils
from salve_tpu_torch.common.pano_data import PanoData
from salve_tpu_torch.common.posegraph2d import PoseGraph2d
from salve_tpu_torch.common.wdo import WDO
from salve_tpu_torch.geometry.simplify import rdp

RAMER_DOUGLAS_PEUCKER_EPSILON = 0.02
WDO_TYPES = ("windows", "doors", "openings")


@dataclass
class MHNetDWO:
    """Horizontal [start, end] extent of one W/D/O, normalized to [0,1]."""

    s: float
    e: float

    @classmethod
    def from_json(cls, json_data: Any) -> "MHNetDWO":
        if len(json_data) != 2:
            raise RuntimeError("W/D/O wall feature must be a [start, end] pair.")
        return cls(s=json_data[0], e=json_data[1])


@dataclass
class MHNetPanoStructurePrediction:
    """MHNet structure prediction for one panorama.

    Attributes:
        corners_in_uv: (C,2) normalized (u,v) corner locations, interleaved
            floor/ceiling per corner.
        image_height / image_width: prediction resolution.
        floor_boundary: (1024,) per-column v-coordinate of the floor boundary.
        floor_boundary_uncertainty: (1024,) per-column uncertainty.
        doors / openings / windows: horizontal W/D/O spans (seam-merged).
        image_fpath: corresponding panorama image path.
    """

    corners_in_uv: np.ndarray
    image_height: int
    image_width: int
    floor_boundary: np.ndarray
    floor_boundary_uncertainty: np.ndarray
    doors: List[MHNetDWO]
    openings: List[MHNetDWO]
    windows: List[MHNetDWO]
    image_fpath: Path

    @classmethod
    def from_json_fpath(cls, json_fpath: Path, image_fpath: Path) -> "MHNetPanoStructurePrediction":
        json_data = io_utils.read_json_file(json_fpath)["predictions"]
        wall_features = json_data["wall_features"]
        return cls(
            image_height=json_data["image_height"],
            image_width=json_data["image_width"],
            corners_in_uv=np.array(json_data["room_shape"]["corners_in_uv"]),
            floor_boundary=np.array(json_data["room_shape"]["raw_predictions"]["floor_boundary"]),
            floor_boundary_uncertainty=np.array(
                json_data["room_shape"]["raw_predictions"]["floor_boundary_uncertainty"]
            ),
            doors=merge_wdos_straddling_img_border(
                [MHNetDWO.from_json(d) for d in wall_features["door"]]
            ),
            windows=merge_wdos_straddling_img_border(
                [MHNetDWO.from_json(w) for w in wall_features["window"]]
            ),
            openings=merge_wdos_straddling_img_border(
                [MHNetDWO.from_json(o) for o in wall_features["opening"]]
            ),
            image_fpath=Path(image_fpath),
        )

    def get_floor_corners_image(self) -> np.ndarray:
        """(C//2, 2) predicted floor corners in pixel coords (odd rows of the interleave).

        The interleave is (ceiling, floor) per corner: on the fixture data the
        odd rows' v-coords coincide with `floor_boundary` at the same column.
        (The reference's same-named getter at mhnet_prediction.py:134 slices
        even rows, contradicting its own data — it only feeds a debug plot.)
        """
        uv = self.corners_in_uv * np.array([self.image_width, self.image_height])
        return uv[1::2]

    def get_ceiling_corners_image(self) -> np.ndarray:
        """(C//2, 2) predicted ceiling corners in pixel coords (even rows)."""
        uv = self.corners_in_uv * np.array([self.image_width, self.image_height])
        return uv[::2]

    def convert_to_pano_data(
        self,
        img_h: int,
        img_w: int,
        pano_id: int,
        gt_pose_graph: PoseGraph2d,
        img_fpath: str,
        vanishing_angle_deg: float,
    ) -> PanoData:
        """Backproject the 1024-column floor boundary + W/D/O spans to a PanoData.

        The layout contour is RDP-simplified at epsilon 0.02 in room coords.
        Camera height is fixed to 1.0 (ego-normalized), matching the reference.
        """
        room_vertices_local_2d, wdos = layout_from_floor_boundary(
            self.floor_boundary,
            {t: [(w.s, w.e) for w in getattr(self, t)] for t in WDO_TYPES},
            img_w,
            gt_pose_graph.nodes[pano_id].global_Sim2_local,
        )

        return PanoData(
            id=pano_id,
            global_Sim2_local=gt_pose_graph.nodes[pano_id].global_Sim2_local,
            room_vertices_local_2d=room_vertices_local_2d,
            image_path=img_fpath,
            label=gt_pose_graph.nodes[pano_id].label,
            doors=wdos["doors"],
            windows=wdos["windows"],
            openings=wdos["openings"],
            vanishing_angle_deg=vanishing_angle_deg,
        )


def layout_from_floor_boundary(
    floor_boundary: np.ndarray,
    spans: Dict[str, Sequence[Tuple[float, float]]],
    img_w: int,
    global_Sim2_local,
) -> Tuple[np.ndarray, Dict[str, List[WDO]]]:
    """A pano's room and W/D/Os from its per-column floor boundary.

    The boundary (one row a column of an image `img_w` wide, twice as wide
    as high) is rounded to whole rows and backprojected onto the floor of a
    camera at height 1.0 (ego-normalized, as the reference), and the
    contour RDP-simplified at epsilon 0.02 in room coords. Each W/D/O span
    (s, e) of `spans` (fractions of the width, by type: "windows", "doors",
    "openings") has its endpoints at the unrounded boundary's rows of its
    ends, backprojected the same way. Returns (room vertices (V, 2), the
    W/D/Os by type). MHNet's parser (`convert_to_pano_data`) and the fused
    scorer's HorizonNet path (pipeline/fused_inference.py) both call this.
    """
    camera_height_m = 1.0

    u = np.arange(len(floor_boundary))
    v = np.round(floor_boundary)
    boundary_px = np.stack([u, v], axis=-1).astype(np.float64)
    room_vertices = pano_projection.pixel_to_worldmetric(
        boundary_px, image_width=img_w, camera_height_m=camera_height_m
    )
    room_vertices_local_2d = rdp(room_vertices[:, :2], epsilon=RAMER_DOUGLAS_PEUCKER_EPSILON)

    wdos: Dict[str, List[WDO]] = {t: [] for t in WDO_TYPES}
    for wdo_type in WDO_TYPES:
        for s, e in spans[wdo_type]:
            s_u = float(np.clip(s * img_w, 0, img_w - 1))
            e_u = float(np.clip(e * img_w, 0, img_w - 1))
            endpoints_px = np.array(
                [
                    [s_u, floor_boundary[round(s_u)]],
                    [e_u, floor_boundary[round(e_u)]],
                ]
            )
            endpoints_world = pano_projection.pixel_to_worldmetric(
                endpoints_px, image_width=img_w, camera_height_m=camera_height_m
            )
            wdos[wdo_type].append(
                WDO(
                    global_Sim2_local=global_Sim2_local,
                    pt1=(endpoints_world[0, 0], endpoints_world[0, 1]),
                    pt2=(endpoints_world[1, 0], endpoints_world[1, 1]),
                    bottom_z=-np.nan,
                    top_z=np.nan,
                    type=wdo_type,
                )
            )
    return room_vertices_local_2d, wdos


def merge_wdos_straddling_img_border(wdo_instances: List[MHNetDWO]) -> List[MHNetDWO]:
    """Merge a W/D/O split in two by the panorama seam.

    If one instance starts within 1% of the left edge and another ends within
    1% of the right edge, they are the two halves of one object wrapping the
    seam; replace them with a single span from the right piece's start to the
    left piece's end.
    """
    if len(wdo_instances) <= 1:
        return wdo_instances

    straddles_left = np.array([wdo.s < 0.01 for wdo in wdo_instances])
    straddles_right = np.array([wdo.e > 0.99 for wdo in wdo_instances])
    if not (straddles_left.any() and straddles_right.any()):
        return wdo_instances

    left_idx = int(np.argmax(straddles_left))
    right_idx = int(np.argmax(straddles_right))
    merged = [w for i, w in enumerate(wdo_instances) if i not in (left_idx, right_idx)]
    merged.append(MHNetDWO(s=wdo_instances[right_idx].s, e=wdo_instances[left_idx].e))
    return merged
