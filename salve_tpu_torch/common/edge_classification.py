"""CNN verdicts per alignment hypothesis, reconstructed from serialized
prediction batches (parity: salve/common/edge_classification.py).

The Stage C -> Stage D interface is filename-driven: batch JSONs carry the
rendering file paths, whose grammar encodes (pair idx, W/D/O pair uuid,
configuration, floor, pano ids); the Sim(2) hypothesis itself is re-read
from the Stage A JSON tree.

A copy of salve_tpu/common/edge_classification.py (no JAX).
"""

from __future__ import annotations

import glob
from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from salve_tpu_torch.common.edgewdopair import EdgeWDOPair
from salve_tpu_torch.common.two_view_estimation_report import TwoViewEstimationReport
from salve_tpu_torch.geometry.rotations import wrap_angle_deg
from salve_tpu_torch.geometry.sim2 import Sim2
from salve_tpu_torch.utils.io import read_json_file


@dataclass
class EdgeClassification:
    """Model prediction for one alignment hypothesis between panos i1, i2."""

    i1: int
    i2: int
    prob: float
    y_hat: int
    y_true: int
    pair_idx: int
    wdo_pair_uuid: str
    configuration: str
    building_id: str
    floor_id: str
    i2Si1: Sim2

    def compute_measurement_relative_pose_error_from_gt(
        self, gt_floor_pose_graph
    ) -> Tuple[float, float]:
        """Relative-pose error of this hypothesis vs the GT pose graph."""
        wTi1_gt = gt_floor_pose_graph.nodes[self.i1].global_Sim2_local
        wTi2_gt = gt_floor_pose_graph.nodes[self.i2].global_Sim2_local
        i2Ti1_gt = wTi2_gt.inverse().compose(wTi1_gt)

        rot_error_deg = wrap_angle_deg(i2Ti1_gt.theta_deg, self.i2Si1.theta_deg)
        trans_error = float(
            np.linalg.norm(i2Ti1_gt.translation - self.i2Si1.translation)
        )
        return rot_error_deg, trans_error


def _parse_floor_id(fname_stem: str) -> str:
    s = fname_stem.find("floor_0")
    e = fname_stem.find("_partial")
    return fname_stem[s:e]


def get_available_floor_ids_building_ids_from_serialized_preds(
    serialized_preds_json_dir: str,
) -> List[Tuple[str, str]]:
    """Unique (building_id, floor_id) pairs with serialized predictions."""
    pairs = set()
    for json_fpath in glob.glob(f"{serialized_preds_json_dir}/batch*.json"):
        for fp0 in read_json_file(json_fpath)["fp0"]:
            building_id = Path(fp0).parent.stem
            pairs.add((building_id, _parse_floor_id(Path(fp0).stem)))
    return list(pairs)


def get_edge_classifications_from_serialized_preds(
    query_building_id: str,
    query_floor_id: str,
    serialized_preds_json_dir: str,
    hypotheses_save_root: str,
    allowed_wdo_types: List[str] = ["door", "window", "opening"],
    confidence_threshold: Optional[float] = None,
) -> Dict[Tuple[str, str], List[EdgeClassification]]:
    """Parse batch JSONs back into per-floor EdgeClassification lists.

    Filename grammar (edge_classification.py:143-176): e.g.
    `pair_3905___door_3_0_identity_floor_rgb_floor_01_partial_room_02_pano_38.jpg`.
    """
    out: Dict[Tuple[str, str], List[EdgeClassification]] = defaultdict(list)

    for json_fpath in glob.glob(f"{serialized_preds_json_dir}/batch*.json"):
        data = read_json_file(json_fpath)
        for y_hat, y_true, y_hat_prob, fp0, fp1 in zip(
            data["y_hat"], data["y_true"], data["y_hat_probs"], data["fp0"], data["fp1"]
        ):
            i1_ = int(Path(fp0).stem.split("_")[-1])
            i2_ = int(Path(fp1).stem.split("_")[-1])
            i1, i2 = min(i1_, i2_), max(i1_, i2_)

            building_id = Path(fp0).parent.stem
            if building_id != query_building_id:
                continue
            floor_id = _parse_floor_id(Path(fp0).stem)
            if floor_id != query_floor_id:
                continue

            pair_idx = int(Path(fp0).stem.split("_")[1])
            configuration = "identity" if "identity" in Path(fp0).stem else "rotated"

            suffix = Path(fp0).stem.split("___")[1]
            k = suffix.find(f"_{configuration}")
            assert k != -1
            wdo_pair_uuid = suffix[:k]
            if wdo_pair_uuid.split("_")[0] not in allowed_wdo_types:
                continue

            if confidence_threshold is not None and y_hat_prob < confidence_threshold:
                continue

            label_dirname = "gt_alignment_approx" if y_true else "incorrect_alignment"
            hyp_fpaths = glob.glob(
                f"{hypotheses_save_root}/{building_id}/{floor_id}"
                f"/{label_dirname}/{i1}_{i2}__{wdo_pair_uuid}_{configuration}.json"
            )
            if len(hyp_fpaths) != 1:
                raise ValueError(
                    "No corresponding serialized alignment hypothesis found for measurement."
                )
            i2Si1 = Sim2.from_json(hyp_fpaths[0])

            out[(building_id, floor_id)].append(
                EdgeClassification(
                    i1=i1,
                    i2=i2,
                    prob=y_hat_prob,
                    y_hat=y_hat,
                    y_true=y_true,
                    pair_idx=pair_idx,
                    wdo_pair_uuid=wdo_pair_uuid,
                    configuration=configuration,
                    building_id=building_id,
                    floor_id=floor_id,
                    i2Si1=i2Si1,
                )
            )
    return out


def get_conf_thresholded_edge_measurements(
    measurements: List[EdgeClassification], confidence_threshold: float
) -> List[EdgeClassification]:
    """Positive predictions above the confidence threshold (parity :213)."""
    return [
        m
        for m in measurements
        if m.y_hat == 1 and m.prob >= confidence_threshold
    ]


def get_most_likely_relative_pose_per_edge(
    measurements: List[EdgeClassification],
    gt_floor_pose_graph=None,
) -> Tuple[
    Dict[Tuple[int, int], Sim2],
    Dict[Tuple[int, int], TwoViewEstimationReport],
    Dict[Tuple[int, int], EdgeWDOPair],
    Dict[Tuple[int, int], EdgeClassification],
]:
    """Most confident measurement per multigraph edge (parity :254)."""
    by_edge: Dict[Tuple[int, int], List[EdgeClassification]] = defaultdict(list)
    for m in measurements:
        by_edge[(m.i1, m.i2)].append(m)

    i2Si1_dict: Dict[Tuple[int, int], Sim2] = {}
    per_edge_wdo_dict: Dict[Tuple[int, int], EdgeWDOPair] = {}
    edge_classification_dict: Dict[Tuple[int, int], EdgeClassification] = {}

    for (i1, i2), ms in by_edge.items():
        m = ms[int(np.argmax([x.prob for x in ms]))]
        per_edge_wdo_dict[(i1, i2)] = EdgeWDOPair.from_wdo_pair_uuid(
            i1=i1, i2=i2, wdo_pair_uuid=m.wdo_pair_uuid
        )
        edge_classification_dict[(i1, i2)] = m
        i2Si1_dict[(i1, i2)] = m.i2Si1

    two_view_reports_dict = create_two_view_reports_dict_from_edge_classification_dict(
        edge_classification_dict, gt_floor_pose_graph
    )
    return i2Si1_dict, two_view_reports_dict, per_edge_wdo_dict, edge_classification_dict


def create_two_view_reports_dict_from_edge_classification_dict(
    edge_classification_dict: Dict[Tuple[int, int], EdgeClassification],
    gt_floor_pose_graph,
) -> Dict[Tuple[int, int], TwoViewEstimationReport]:
    """(R,t) errors w.r.t. GT per edge (None-safe when GT is absent)."""
    reports: Dict[Tuple[int, int], TwoViewEstimationReport] = {}
    for (i1, i2), m in edge_classification_dict.items():
        if gt_floor_pose_graph is None:
            reports[(i1, i2)] = TwoViewEstimationReport(
                gt_class=m.y_true, confidence=m.prob
            )
            continue
        R_err, U_err = m.compute_measurement_relative_pose_error_from_gt(
            gt_floor_pose_graph
        )
        reports[(i1, i2)] = TwoViewEstimationReport(
            gt_class=m.y_true, R_error_deg=R_err, U_error_deg=U_err, confidence=m.prob
        )
    return reports
