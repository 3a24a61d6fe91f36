"""Seeded inputs for stitching on procedural buildings.

Stitching reads layout predictions that no model writes here. This module
writes them from a procedural building's ground-truth rooms, with seeded
noise, so that the fused rooms land near the true ones and both packages
read the same files:

  * `write_layout_predictions`: ModifiedHorizonNet prediction JSONs under
    `root/horizon_net/<building>/`, the schema of
    `seeded_predictions.write_seeded_mhnet_predictions`, read by
    `cli/stitch_floor_plan.py` (run_sfm's poses);
  * `write_cluster_inputs`: the cluster flow's files
    (`stitching/cluster_stitching.py`): per 10-hex pano ID
    `rmx-madori-v1_predictions.json` and `rmx-dwo-rcnn_predictions.json`,
    a ZInD `floor_map.json`, and `cluster_pred.json` built from run_sfm's
    serialized poses.

Each field is made so that the function reading it recovers the room:
  * the dense floor boundary (v px per column) by casting stitching's own
    column rays (`stitching/transform.py:u_to_xy`) against the pano's room
    in the stitching frame (its local layout times the pose's scale), then
    v = 1 - atan(r / h) / pi at stitching's camera height, plus noise;
  * the horizon_net corners by inverting `pixel_to_worldmetric` at camera
    height 1 (what `dataset/salve_sfm_result_loader.py` applies);
  * the madori corners by `stitching/transform.py:xy_to_uv` (what
    `shape.load_room_shape_polygon_from_predictions` inverts);
  * the per-column uncertainty from `seeded_predictions.boundary_uncertainty`.

Poses are those of `cli/stitch_floor_plan.py:pose_from_sim2`
(salve_tpu/cli/stitch_floor_plan.py:28-37): position t * s, rotation
-theta in degrees (stitching rotates clockwise).
"""

from __future__ import annotations

import hashlib
import json
import math
from pathlib import Path
from typing import Dict, List

import numpy as np

from salve_tpu_torch.cli.stitch_floor_plan import pose_from_sim2
from salve_tpu_torch.common.pano_data import PanoData
from salve_tpu_torch.dataset.seeded_predictions import boundary_uncertainty
from salve_tpu_torch.geometry.sim2 import Sim2
from salve_tpu_torch.stitching import transform
from salve_tpu_torch.stitching.constants import (
    DEFAULT_CAMERA_HEIGHT,
    IMAGE_HEIGHT_PX,
    IMAGE_WIDTH_PX,
    JOINT_MADORI_V1_FILENAME,
    WDO_FILENAME2,
)
from salve_tpu_torch.stitching.models import Point2d

BOUNDARY_NOISE_PX = 0.8


def hex_pano_id(building_id: str, pano_id: int) -> str:
    """The 10-hex pano ID the cluster flow's loader expects."""
    return hashlib.sha1(f"{building_id}/{pano_id}".encode()).hexdigest()[:10]


def stitching_pose(S: Sim2) -> tuple:
    """(x, y, rotation deg clockwise) of a Sim(2) pose, as stitching reads it."""
    pose = pose_from_sim2(S)
    return float(pose.position.x), float(pose.position.y), pose.rotation


def _ray_distances(us: np.ndarray, ring: np.ndarray) -> np.ndarray:
    """Distance from the origin to the nearest wall of `ring` along each
    stitching column ray u (transform.u_to_xy)."""
    phi = ((us + 0.5) % 1.0) * math.pi * 2.0
    d = np.stack([np.sin(phi), np.cos(phi)], -1)[:, None, :]  # (K, 1, 2)
    a = ring[None]
    e = (np.roll(ring, -1, axis=0) - ring)[None]

    def cross(p, q):
        return p[..., 0] * q[..., 1] - p[..., 1] * q[..., 0]

    denom = cross(d, e)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = cross(a, e) / denom
        s = cross(a, d) / denom
    hit = (np.abs(denom) > 1e-12) & (t > 1e-9) & (s >= 0) & (s <= 1)
    r = np.where(hit, t, np.inf).min(axis=1)
    if not np.isfinite(r).all():
        raise ValueError("a column ray leaves the room: the camera is not inside its layout")
    return r


def dense_boundary(ring_stitch: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """(1024,) floor boundary in px of the room `ring_stitch` (stitching
    frame), as `shape.generate_dense_shape` reads it, plus seeded noise."""
    us = np.arange(IMAGE_WIDTH_PX) / IMAGE_WIDTH_PX + 0.5 / IMAGE_WIDTH_PX
    r = _ray_distances(us, ring_stitch)
    v = 1.0 - np.arctan2(r, DEFAULT_CAMERA_HEIGHT) / math.pi - 0.5 / IMAGE_HEIGHT_PX
    v_px = v * IMAGE_HEIGHT_PX + rng.normal(0, BOUNDARY_NOISE_PX, IMAGE_WIDTH_PX)
    return np.clip(v_px, IMAGE_HEIGHT_PX / 2 + 1, IMAGE_HEIGHT_PX - 1)


def _interleave(floor_uv: np.ndarray) -> np.ndarray:
    """Ceiling/floor interleave of MHNet's corners: the floor corners at the
    odd rows, each ceiling corner mirrored about the horizon."""
    out = np.empty((2 * len(floor_uv), 2))
    out[1::2] = floor_uv
    out[0::2, 0] = floor_uv[:, 0]
    out[0::2, 1] = 1.0 - floor_uv[:, 1]
    return out


def horizon_net_corners(local: np.ndarray) -> np.ndarray:
    """(2N, 2) normalized corners whose floor rows `pixel_to_worldmetric`
    (camera height 1, as salve_sfm_result_loader reads them) maps back to
    the (N, 2) `local` layout."""
    theta = np.arctan2(local[:, 0], local[:, 1])
    phi = -np.arctan2(1.0, np.linalg.norm(local, axis=1))
    px = (theta + math.pi) / (2 * math.pi) * (IMAGE_WIDTH_PX - 1)
    py = (1.0 - (phi + math.pi / 2) / math.pi) * (IMAGE_HEIGHT_PX - 1)
    return _interleave(np.stack([px / IMAGE_WIDTH_PX, py / IMAGE_HEIGHT_PX], -1))


def madori_corners(ring_stitch: np.ndarray) -> np.ndarray:
    """(2N, 2) corners whose floor rows
    `shape.load_room_shape_polygon_from_predictions` maps back to the
    (N, 2) stitching-frame ring."""
    uv = [transform.xy_to_uv(Point2d(x=p[0], y=p[1]), DEFAULT_CAMERA_HEIGHT) for p in ring_stitch]
    floor = np.array([[q.x - 0.5 / IMAGE_WIDTH_PX, q.y - 0.5 / IMAGE_HEIGHT_PX] for q in uv])
    return _interleave(floor)


def _floor_panos(building_json: dict) -> List[tuple]:
    """(partial room key, PanoData) of floor_01's panos, in file order."""
    out = []
    for cr_key, complete in building_json["merger"]["floor_01"].items():
        for pr_key, partial in complete.items():
            for pano in partial.values():
                out.append((f"{cr_key}/{pr_key}", PanoData.from_json(pano)))
    return out


def _pano_layout(pano: PanoData, rng: np.random.Generator) -> Dict[str, list]:
    ring = pano.room_vertices_local_2d * pano.global_Sim2_local.scale
    return {
        "floor_boundary": dense_boundary(ring, rng).tolist(),
        "floor_boundary_uncertainty": boundary_uncertainty(rng).tolist(),
    }


def write_layout_predictions(root: Path, building_id: str, building_json: dict, seed: int) -> None:
    """MHNet prediction JSONs of floor_01's panos under
    `root/horizon_net/<building>/`, made from the true rooms."""
    rng = np.random.default_rng(seed)
    out = Path(root) / "horizon_net" / building_id
    out.mkdir(parents=True)
    for _, pano in _floor_panos(building_json):
        pred = {
            "image_height": IMAGE_HEIGHT_PX,
            "image_width": IMAGE_WIDTH_PX,
            "room_shape": {
                "corners_in_uv": horizon_net_corners(pano.room_vertices_local_2d).tolist(),
                "raw_predictions": _pano_layout(pano, rng),
            },
            "wall_features": {"door": [], "window": [], "opening": []},
        }
        (out / f"{Path(pano.image_path).stem}.json").write_text(json.dumps({"predictions": pred}))


def write_cluster_inputs(root: Path, building_id: str, building_json: dict, serialized_fpath: str,
                         seed: int) -> Dict[str, str]:
    """The cluster flow's files under `root` for floor_01 (module docstring).

    Two clusters: every pano that run_sfm localized, and the first half of
    them; each in a frame of its own (a seeded rigid motion of the
    serialized poses), anchored to the ground truth at its first pano by
    `stitching/ground_truth_utils.py`.

    Returns the paths: `pred_dir`, `floor_map`, `clusters`.
    """
    rng = np.random.default_rng(seed)
    root = Path(root)
    pred_dir = root / "madori"
    panos = _floor_panos(building_json)
    room_shapes: Dict[str, dict] = {}
    floor_map_panos: Dict[str, dict] = {}
    for order, (room_key, pano) in enumerate(panos):
        hid = hex_pano_id(building_id, pano.id)
        rsid = room_key.replace("/", "__")
        x, y, rot = stitching_pose(pano.global_Sim2_local)
        room = room_shapes.setdefault(rsid, {
            "vertices": [{"x": float(p[0]), "y": float(p[1])} for p in pano.room_vertices_global_2d],
            "panos": {}, "doors": {}, "windows": {}, "openings": {},
        })
        room["panos"][hid] = {"position": {"x": x, "y": y}, "rotation": rot}
        floor_map_panos[hid] = {"room_shape_id": rsid, "order": order, "pano_id": pano.id}

        ring = pano.room_vertices_local_2d * pano.global_Sim2_local.scale
        (pred_dir / hid).mkdir(parents=True)
        madori = {"room_shape": {"corners_in_uv": madori_corners(ring).tolist(),
                                 "raw_predictions": _pano_layout(pano, rng)}}
        (pred_dir / hid / JOINT_MADORI_V1_FILENAME).write_text(json.dumps([{"predictions": madori}]))
        wdo = [[int(rng.integers(1, 4)), float(rng.uniform(0.3, 1.0)), float(u), 0.0, float(u + 0.05)]
               for u in rng.uniform(0, 0.9, 3)]
        (pred_dir / hid / WDO_FILENAME2).write_text(json.dumps({"predictions": {"wdo": [wdo]}}))

    scale = float(building_json["scale_meters_per_coordinate"]["floor_01"])
    floor_map = {
        "panos": floor_map_panos,
        "room_shapes": room_shapes,
        "floor_shapes": {"floor_shape_01": {
            "floor_number": 1, "scale": scale,
            "room_shapes": {rsid: {"position": {"x": 0.0, "z": 0.0}, "rotation": 0.0, "scale": 1.0}
                            for rsid in room_shapes},
        }},
    }
    (root / "floor_map.json").write_text(json.dumps(floor_map))

    wSi = json.loads(Path(serialized_fpath).read_text())["wSi_dict"]
    ids = sorted(int(i) for i in wSi)
    clusters = []
    for members in (ids, ids[: max(1, len(ids) // 2)]):
        th = rng.uniform(-np.pi, np.pi)
        R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        shift = rng.uniform(-5, 5, 2)
        cluster = {}
        for i in members:
            w = wSi[str(i)]
            x, y, rot = stitching_pose(Sim2(np.array(w["R"]), np.array(w["t"]), w["s"]))
            xy = R @ np.array([x, y]) + shift
            cluster[hex_pano_id(building_id, i)] = {
                "pose": {"x": float(xy[0]), "y": float(xy[1]), "rotation": rot - float(np.degrees(th))}}
        clusters.append({"floor_id": "floor_01", "scale": scale, "panos": cluster,
                         "start_panoid": hex_pano_id(building_id, members[0])})
    (root / "cluster_pred.json").write_text(json.dumps(clusters))
    return {"pred_dir": str(pred_dir), "floor_map": str(root / "floor_map.json"),
            "clusters": str(root / "cluster_pred.json")}
