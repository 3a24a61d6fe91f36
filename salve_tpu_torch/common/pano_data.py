"""Per-panorama containers + ZInD pose-annotation conversion.

Parity: salve/common/pano_data.py, including the ZInD left-handed ->
right-handed conversion (x negation + transposed rotation) and the
"sRp + t" (ZInD) -> "s(Rp + t)" (Sim(2)) convention change.

A copy of salve_tpu/common/pano_data.py (no JAX); `plot_room_layout` takes
matplotlib through `utils/plotting.py`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np

from salve_tpu_torch.common.wdo import WDO
from salve_tpu_torch.geometry.rotations import rotmat2d
from salve_tpu_torch.geometry.sim2 import Sim2
from salve_tpu_torch.utils import plotting


class CoordinateFrame(str, Enum):
    """Coordinate-frame tags (see reference COORDINATE_FRAMES.md)."""

    LOCAL = "local"
    WORLD_NORMALIZED = "worldnormalized"
    WORLD_METRIC = "worldmetric"


@dataclass
class PanoData:
    """All per-panorama information for one pano of one floor.

    Attributes:
        id: integer pano ID (parsed from the image filename stem).
        global_Sim2_local: pano pose, world-normalized <- ego-normalized.
        room_vertices_local_2d: (N,2) room-layout boundary in the local frame.
        image_path: pano path relative to the ZInD building directory.
        label: room-category annotation (e.g. "kitchen").
        doors / windows / openings: W/D/O lists.
        vanishing_angle_deg: dominant vanishing direction (inferred data only).
    """

    id: int
    global_Sim2_local: Sim2
    room_vertices_local_2d: np.ndarray
    image_path: str
    label: str
    doors: Optional[List[WDO]] = field(default_factory=list)
    windows: Optional[List[WDO]] = field(default_factory=list)
    openings: Optional[List[WDO]] = field(default_factory=list)
    vanishing_angle_deg: Optional[float] = None

    @property
    def room_vertices_global_2d(self) -> np.ndarray:
        return self.global_Sim2_local.transform_from(self.room_vertices_local_2d)

    @property
    def all_wdos(self) -> List[WDO]:
        return list(self.doors or []) + list(self.windows or []) + list(self.openings or [])

    def plot_room_layout(
        self,
        coord_frame: str,
        show_plot: bool = True,
        scale_meters_per_coordinate: Optional[float] = None,
    ) -> None:
        """Draw this room's layout, camera marker + heading, and W/D/Os.

        Parity: salve/common/pano_data.py:134 — windows red, doors green,
        openings blue; the camera's +y heading marks the pano center column.

        Args:
            coord_frame: 'local', 'worldnormalized', or 'worldmetric'.
            show_plot: show the canvas, or silently add artists to it.
            scale_meters_per_coordinate: required for 'worldmetric'.
        """
        plt = plotting.pyplot("PanoData.plot_room_layout", agg=False)

        if coord_frame not in ("worldmetric", "worldnormalized", "local"):
            raise ValueError(f"Unknown coordinate frame provided: {coord_frame}.")

        is_global = coord_frame in ("worldmetric", "worldnormalized")
        room_vertices = (
            self.room_vertices_global_2d if is_global else self.room_vertices_local_2d
        ).copy()
        if coord_frame == "worldmetric":
            if scale_meters_per_coordinate is None:
                print(
                    "Scale is required to convert coordinates to meters; skipping rendering."
                )
                return
            room_vertices *= scale_meters_per_coordinate
        else:
            scale_meters_per_coordinate = 1.0

        ring = np.vstack([room_vertices, room_vertices[:1]])
        plt.plot(ring[:, 0], ring[:, 1], linewidth=1)

        pano_position = np.zeros((1, 2))
        heading = np.array([[0.0, 0.3]])
        if is_global:
            pano_position = (
                self.global_Sim2_local.transform_from(pano_position)
                * scale_meters_per_coordinate
            )
            heading = (
                self.global_Sim2_local.transform_from(heading)
                * scale_meters_per_coordinate
            )
        plt.scatter(pano_position[0, 0], pano_position[0, 1], 30, marker="+")
        plt.arrow(
            pano_position[0, 0],
            pano_position[0, 1],
            heading[0, 0] - pano_position[0, 0],
            heading[0, 1] - pano_position[0, 1],
            width=0.01,
        )
        plt.text(pano_position[0, 0], pano_position[0, 1], str(self.id), fontsize=8)

        wdo_colors = {"windows": "r", "doors": "g", "openings": "b"}
        for wdo in self.all_wdos:
            verts = wdo.vertices_global_2d if is_global else wdo.vertices_local_2d
            verts = verts * scale_meters_per_coordinate
            plt.plot(verts[:, 0], verts[:, 1], color=wdo_colors[wdo.type], linewidth=2)

        if show_plot:
            plt.axis("equal")
            plt.show()

    @classmethod
    def from_json(cls, pano_data: Any) -> "PanoData":
        """Parse one pano's entry of ZInD zind_data.json (uses the `layout_raw` variant)."""
        assert pano_data["camera_height"] == 1.0

        image_path = pano_data["image_path"]
        pano_id = int(Path(image_path).stem.split("_")[-1])
        global_Sim2_local = generate_Sim2_from_floorplan_transform(
            pano_data["floor_plan_transformation"]
        )

        room_vertices = np.asarray(pano_data["layout_raw"]["vertices"], dtype=np.float64)
        room_vertices[:, 0] *= -1  # left-handed -> right-handed

        parsed: Dict[str, List[WDO]] = {"windows": [], "doors": [], "openings": []}
        for wdo_type in ("windows", "doors", "openings"):
            raw = pano_data["layout_raw"][wdo_type]
            if len(raw) == 0:
                continue
            # Stored as flat triplets: (x1,y1), (x2,y2), (bottom_z, top_z).
            assert len(raw) % 3 == 0
            for k in range(len(raw) // 3):
                parsed[wdo_type].append(
                    WDO.from_object_array(raw[k * 3 : (k + 1) * 3], global_Sim2_local, wdo_type)
                )

        return cls(
            id=pano_id,
            global_Sim2_local=global_Sim2_local,
            room_vertices_local_2d=room_vertices,
            image_path=image_path,
            label=pano_data["label"],
            doors=parsed["doors"],
            windows=parsed["windows"],
            openings=parsed["openings"],
            vanishing_angle_deg=None,
        )


class FloorData(NamedTuple):
    """All panoramas of one floor of one building."""

    floor_id: str
    panos: List[PanoData]

    @classmethod
    def from_json(cls, floor_data: Any, floor_id: str) -> "FloorData":
        """Parse a `merger` floor entry: complete-room -> partial-room -> pano nesting."""
        pano_objs = [
            PanoData.from_json(pano_data)
            for complete_room_data in floor_data.values()
            for partial_room_data in complete_room_data.values()
            for pano_data in partial_room_data.values()
        ]
        return cls(floor_id, pano_objs)


def generate_Sim2_from_floorplan_transform(transform_data: Dict[str, Any]) -> Sim2:
    """ZInD `floor_plan_transformation` dict -> Sim(2) pano pose.

    ZInD applies (sRp + t) followed by a reflection over the y-axis; the
    equivalent reflection-free form uses R^T and t with x negated, and the
    translation is divided by s to express the action in s(Rp + t) form.
    """
    scale = transform_data["scale"]
    t = np.array(transform_data["translation"]) / scale
    t *= np.array([-1.0, 1.0])
    R = rotmat2d(-transform_data["rotation"])
    assert np.allclose(R.T @ R, np.eye(2))
    return Sim2(R=R, t=t, s=scale)
