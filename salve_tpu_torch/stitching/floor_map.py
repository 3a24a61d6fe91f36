"""GT floor-map accessor for stitch evaluation.

Parity: salve/stitching/models/floor_map_object.py — the ZInD "floor_map"
JSON (panos / room_shapes / floor_shapes) with room->floor associations and
room-cs -> floor-global coordinate lifts. GEOS/schematics-free.

A copy of salve_tpu/stitching/floor_map.py (no JAX).
"""

from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, List, Optional

import numpy as np

from salve_tpu_torch.stitching.models import Point2d, Pose
from salve_tpu_torch.stitching.transform import get_global_coords_2d_from_room_cs


class FloorMapObject:
    """Wraps a floor_map dict (floor_map_gt.json / zind floor_map schema)."""

    def __init__(self, floor_map: Dict[str, Any]) -> None:
        self.data = floor_map
        # room shape id -> floor shape id (reference :27-31).
        self.fsids: Dict[str, str] = {}
        for fsid, floor_shape in self.data["floor_shapes"].items():
            for rsid in floor_shape["room_shapes"]:
                self.fsids[rsid] = fsid
        self.floor_ids_by_panoid: Dict[str, str] = {}
        self.panoids_by_order: Dict[str, str] = {}
        for panoid, pano in self.data["panos"].items():
            self.panoids_by_order[str(pano["order"])] = panoid
        for fsid, floor_shape in self.data["floor_shapes"].items():
            for rsid in floor_shape["room_shapes"]:
                for panoid in self.data["room_shapes"][rsid]["panos"]:
                    self.floor_ids_by_panoid[panoid] = fsid

    def get_panoids_with_floor_id(self, floor_shape_id: str) -> List[str]:
        return [
            panoid
            for panoid, fsid in self.floor_ids_by_panoid.items()
            if fsid == floor_shape_id
        ]

    def get_floor_shape_id_by_number(self, floor_number: int) -> Optional[str]:
        """Floor shape whose floor_number matches (stitch_floor_plan.py:200-204)."""
        for fsid, floor_shape in self.data["floor_shapes"].items():
            if floor_shape["floor_number"] == floor_number:
                return fsid
        return None

    def get_floor_map_scale(self) -> float:
        fsid_first = next(iter(self.data["floor_shapes"]))
        return self.data["floor_shapes"][fsid_first]["scale"]

    def get_panoid_by_pano_order(self, order: Any) -> str:
        return self.panoids_by_order[str(order)]

    def get_pano_global_pose(self, panoid: str) -> Optional[Pose]:
        """Pano pose in the floor-global frame (reference :70-87)."""
        if panoid not in self.data["panos"]:
            return None
        room_shape_id = self.data["panos"][panoid]["room_shape_id"]
        room_shape_pano = self.data["room_shapes"][room_shape_id]["panos"][panoid]
        pose = Pose(
            position=Point2d(
                x=room_shape_pano["position"]["x"], y=room_shape_pano["position"]["y"]
            ),
            rotation=room_shape_pano["rotation"],
        )
        return self.get_global_pose_from_pose_in_room_cs(room_shape_id, pose)

    def get_global_pose_from_pose_in_room_cs(
        self, room_shape_id: str, pose: Pose
    ) -> Pose:
        fsid = self.fsids[room_shape_id]
        fs_rs = self.data["floor_shapes"][fsid]["room_shapes"][room_shape_id]
        position_global = get_global_coords_2d_from_room_cs(
            [pose.position.x, pose.position.y],
            fs_rs["position"]["x"],
            fs_rs["position"]["z"],
            fs_rs["rotation"],
            fs_rs["scale"],
        )[0]
        return Pose(
            position=Point2d(x=position_global[0], y=position_global[1]),
            rotation=pose.rotation + fs_rs["rotation"],
        )

    def get_room_shape_global(
        self, room_shape_id: str, pose: Optional[Pose] = None
    ) -> Dict[str, Any]:
        """Room shape with vertices + W/D/O endpoints lifted to the global
        frame (reference :117-171)."""
        room_shape_original = self.data["room_shapes"][room_shape_id]
        room_shape = deepcopy(room_shape_original)
        if pose is not None:
            xz = [-pose.position.x, pose.position.y]
            rotation, scale = pose.rotation, 1.0
        else:
            fsid = self.fsids[room_shape_id]
            fs_rs = self.data["floor_shapes"][fsid]["room_shapes"][room_shape_id]
            xz = [fs_rs["position"]["x"], fs_rs["position"]["z"]]
            rotation, scale = fs_rs["rotation"], fs_rs["scale"]

        def _lift(xy) -> Dict[str, float]:
            g = get_global_coords_2d_from_room_cs(
                [xy["x"], xy["y"]], xz[0], xz[1], rotation, scale
            )[0]
            return {"x": float(g[0]), "y": float(g[1])}

        for wdo_type in ("doors", "windows", "openings"):
            for entityid, obj in room_shape_original.get(wdo_type, {}).items():
                room_shape[wdo_type][entityid]["position"][0] = _lift(obj["position"][0])
                room_shape[wdo_type][entityid]["position"][1] = _lift(obj["position"][1])

        room_shape["vertices"] = [_lift(v) for v in room_shape_original["vertices"]]
        return room_shape

    def get_room_shape_global_ring(self, room_shape_id: str) -> np.ndarray:
        """Global-frame room polygon as an (N,2) ring."""
        verts = self.get_room_shape_global(room_shape_id)["vertices"]
        return np.array([[v["x"], v["y"]] for v in verts], dtype=np.float64)
