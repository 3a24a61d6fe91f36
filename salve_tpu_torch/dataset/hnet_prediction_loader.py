"""Load ModifiedHorizonNet predictions per building/floor into pose graphs.

Parity: salve/dataset/hnet_prediction_loader.py, including the duplicate-pano
workarounds for ZInD buildings 1348 (pano 5) and 0363 (pano 34).

A copy of salve_tpu/dataset/hnet_prediction_loader.py (no JAX).
"""

from __future__ import annotations

import glob
import json
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional

import salve_tpu_torch.common.posegraph2d as posegraph2d
from salve_tpu_torch.common.posegraph2d import PoseGraph2d
from salve_tpu_torch.dataset.mhnet_prediction import MHNetPanoStructurePrediction

IMG_H = 512
IMG_W = 1024


def get_pano_fpath_from_pano_index(i: int, raw_dataset_dir: str, building_id: str) -> str:
    """Resolve a pano image path from its integer index.

    Same glob as the reference (salve/dataset/zind_data.py:42) — the
    `floor*_pano_{i}.jpg` pattern is anchored so pano 5 cannot match pano 15.
    Unlike the reference we tolerate a missing image (Stage A never opens it).
    """
    candidates = glob.glob(f"{raw_dataset_dir}/{building_id}/panos/floor*_pano_{i}.jpg")
    return candidates[0] if candidates else f"{raw_dataset_dir}/{building_id}/panos/pano_{i}.jpg"


def load_hnet_predictions(
    building_id: str, raw_dataset_dir: str, predictions_data_root: str
) -> Optional[Dict[str, Dict[int, MHNetPanoStructurePrediction]]]:
    """Load raw MHNet predictions for every pano of a building, keyed by floor."""
    floor_hnet_predictions: Dict[str, Dict[int, MHNetPanoStructurePrediction]] = defaultdict(dict)
    floor_ids = posegraph2d.compute_available_floors_for_building(
        building_id=building_id, raw_dataset_dir=raw_dataset_dir
    )
    for floor_id in floor_ids:
        floor_gt_pose_graph = posegraph2d.get_gt_pose_graph(
            building_id=building_id, floor_id=floor_id, raw_dataset_dir=raw_dataset_dir
        )
        for i in floor_gt_pose_graph.pano_ids():
            fpaths = glob.glob(f"{predictions_data_root}/horizon_net/{building_id}/*_{i}.json")
            if len(fpaths) == 0:
                print(f"\tPrediction {i} missing for building {building_id}, {floor_id}")
                continue
            if len(fpaths) > 1:
                # ZInD annotation quirk: two buildings have duplicate pano IDs.
                if building_id == "1348" and i == 5:
                    fpath = Path(f"{predictions_data_root}/horizon_net/1348/floor_01_partial_room_12_pano_5.json")
                elif building_id == "0363" and i == 34:
                    fpath = Path(f"{predictions_data_root}/horizon_net/0363/floor_02_partial_room_05_pano_34.json")
                else:
                    fpath = Path(sorted(fpaths)[0])
            else:
                fpath = Path(fpaths[0])
            img_fpath = Path(f"{raw_dataset_dir}/{building_id}/panos/{fpath.stem}.jpg")
            floor_hnet_predictions[floor_id][i] = MHNetPanoStructurePrediction.from_json_fpath(
                json_fpath=fpath, image_fpath=img_fpath
            )
    return floor_hnet_predictions


def load_vanishing_angles(predictions_data_root: str, building_id: str) -> Dict[int, float]:
    """Per-pano precomputed vanishing angles (degrees); empty if not provided.

    Accepts both wire formats: a JSON array indexed by pano id (what the
    reference loader requires — salve/dataset/hnet_prediction_loader.py:153
    indexes it with an int) and a {pano_id: angle} object.
    """
    json_fpath = Path(predictions_data_root) / "vanishing_angle" / f"{building_id}.json"
    if not json_fpath.exists():
        return {}
    with open(json_fpath, "r") as f:
        data = json.load(f)
    if isinstance(data, list):
        return {i: v for i, v in enumerate(data)}
    return {int(k): v for k, v in data.items()}


def load_inferred_floor_pose_graphs(
    building_id: str, raw_dataset_dir: str, predictions_data_root: str
) -> Optional[Dict[str, PoseGraph2d]]:
    """Build per-floor pose graphs holding MHNet-inferred layout + W/D/Os.

    (Poses inside are oracle/GT — Stage A only uses the local geometry.)
    """
    hnet_predictions_dict = load_hnet_predictions(
        building_id=building_id,
        raw_dataset_dir=raw_dataset_dir,
        predictions_data_root=predictions_data_root,
    )
    if hnet_predictions_dict is None:
        return None

    vanishing_angles = load_vanishing_angles(predictions_data_root, building_id)

    floor_pose_graphs: Dict[str, PoseGraph2d] = {}
    for floor_id, floor_predictions in hnet_predictions_dict.items():
        floor_gt_pose_graph = posegraph2d.get_gt_pose_graph(
            building_id=building_id, floor_id=floor_id, raw_dataset_dir=raw_dataset_dir
        )
        floor_pose_graphs[floor_id] = PoseGraph2d(
            building_id=building_id,
            floor_id=floor_id,
            nodes={},
            scale_meters_per_coordinate=floor_gt_pose_graph.scale_meters_per_coordinate,
        )
        for i, pred_obj in floor_predictions.items():
            img_fpath = get_pano_fpath_from_pano_index(
                i=i, raw_dataset_dir=raw_dataset_dir, building_id=building_id
            )
            floor_pose_graphs[floor_id].nodes[i] = pred_obj.convert_to_pano_data(
                img_h=IMG_H,
                img_w=IMG_W,
                pano_id=i,
                gt_pose_graph=floor_gt_pose_graph,
                img_fpath=img_fpath,
                vanishing_angle_deg=vanishing_angles.get(i),
            )
    return floor_pose_graphs


def load_inferred_floor_pose_graph(
    building_id: str, floor_id: str, raw_dataset_dir: str, predictions_data_root: str
) -> PoseGraph2d:
    """Single-floor variant of load_inferred_floor_pose_graphs (raises if missing)."""
    floor_pose_graphs = load_inferred_floor_pose_graphs(
        building_id=building_id,
        raw_dataset_dir=raw_dataset_dir,
        predictions_data_root=predictions_data_root,
    )
    if floor_pose_graphs is None:
        raise ValueError(f"MHNet predictions missing for all floors of ZInD Building {building_id}.")
    if floor_id not in floor_pose_graphs:
        raise ValueError(f"MHNet predictions missing for {floor_id} of ZInD Building {building_id}.")
    return floor_pose_graphs[floor_id]


def get_floor_id_from_img_fpath(img_fpath: str) -> str:
    """'...panos/floor_01_partial_room_03_pano_13.jpg' -> 'floor_01'."""
    fname = Path(img_fpath).name
    return fname[: fname.find("_partial")]
