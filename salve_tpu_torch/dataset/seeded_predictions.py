"""Seeded predictions for Stage D's inputs on procedural buildings.

`write_seeded_predictions`: verifier predictions in the Stage C -> D
`batch_{i}.json` contract. `write_seeded_mhnet_predictions` and
`write_seeded_vanishing_angles`: ModifiedHorizonNet layout predictions in the
schema `dataset/mhnet_prediction.py` parses, and per-pano vanishing angles,
for inferred mode, landmark SLAM and the axis alignment.

Verifier predictions, where no verifier has run: every exported hypothesis of a floor (`gt_alignment_approx` as label 1, then
`incorrect_alignment` as label 0, each in sorted file order) gets a
prediction, with `fp0`/`fp1` named as the fused scoring CLI names them
(`cli/test_fused.py`). The predicted labels are the oracle's, with
confidences drawn in [0.94, 0.999], except:

  * a seeded `demote_frac` of the positives, and every positive of one
    seeded pano a floor (which strands it), keep label 1 at a confidence in
    [0.6, 0.93), below Stage D's 0.93 threshold (so the cluster rescue,
    which takes positives down to 0.5, has work);
  * `n_false_positives` seeded negatives are predicted 1 at a confidence in
    [0.94, 0.999].
"""

from __future__ import annotations

import glob
import json
from pathlib import Path
from typing import Dict, List

import numpy as np

from salve_tpu_torch.cli.test_fused import _parse_hyp_fpath
from salve_tpu_torch.rendering.bev_pair import bev_fname_from_img_fpath
from salve_tpu_torch.utils.io import save_json_file

BATCH = 32


def write_seeded_predictions(
    hypotheses_save_root: str,
    building_id: str,
    img_fpaths: Dict[int, str],
    serialization_save_dir: str,
    seed: int,
    start_batch_idx: int = 0,
    demote_frac: float = 0.15,
    n_false_positives: int = 3,
) -> int:
    """Write one building's predictions; returns the number of batch files.

    `img_fpaths` maps a pano ID to its image path (its stem names the floor
    and the pano, as ZInD's do).
    """
    rng = np.random.default_rng(seed)
    rows: List[tuple] = []  # (fp0, fp1, y_true, floor, i1, i2)
    for floor_dir in sorted(glob.glob(f"{hypotheses_save_root}/{building_id}/floor*")):
        for label_type, y_true in (("gt_alignment_approx", 1), ("incorrect_alignment", 0)):
            for pair_idx, fpath in enumerate(sorted(glob.glob(f"{floor_dir}/{label_type}/*.json"))):
                i1, i2, uuid, configuration = _parse_hyp_fpath(fpath)
                names = [
                    bev_fname_from_img_fpath(pair_idx, f"{uuid}_{configuration}", "floor", img_fpaths[i])
                    for i in (i1, i2)
                ]
                rows.append((*(f"{label_type}/{building_id}/{n}" for n in names), y_true, floor_dir, i1, i2))
    if not rows:
        return 0

    y_true = np.array([r[2] for r in rows])
    y_hat = y_true.copy()
    prob = rng.uniform(0.94, 0.999, len(rows))
    pos, neg = np.flatnonzero(y_true == 1), np.flatnonzero(y_true == 0)
    demoted = set(rng.choice(pos, int(round(demote_frac * len(pos))), replace=False).tolist())
    for floor_dir in sorted({r[3] for r in rows}):
        panos = sorted({i for k in pos if rows[k][3] == floor_dir for i in rows[k][4:6]})
        if panos:
            stranded = panos[int(rng.integers(len(panos)))]
            demoted.update(k for k in pos if rows[k][3] == floor_dir and stranded in rows[k][4:6])
    demoted = np.array(sorted(demoted), dtype=np.int64)
    prob[demoted] = rng.uniform(0.6, 0.93, len(demoted))
    fps = rng.choice(neg, min(n_false_positives, len(neg)), replace=False)
    y_hat[fps] = 1

    n_files = 0
    for start in range(0, len(rows), BATCH):
        sl = slice(start, start + BATCH)
        save_json_file(
            f"{serialization_save_dir}/batch_{start_batch_idx + n_files}.json",
            {
                "y_hat": y_hat[sl].tolist(),
                "y_true": y_true[sl].tolist(),
                "y_hat_probs": prob[sl].tolist(),
                "fp0": [r[0] for r in rows[sl]],
                "fp1": [r[1] for r in rows[sl]],
            },
        )
        n_files += 1
    return n_files


def pano_image_paths(building_json: dict) -> Dict[int, str]:
    """Pano ID -> image path, from a ZInD-format building's `merger` data."""
    out = {}
    for floor in building_json["merger"].values():
        for complete in floor.values():
            for partial in complete.values():
                for pano in partial.values():
                    out[int(Path(pano["image_path"]).stem.split("_")[-1])] = pano["image_path"]
    return out


def write_seeded_mhnet_predictions(root: Path, building_id: str, building_json: dict, seed: int) -> None:
    """Seeded MHNet prediction JSONs under `root/horizon_net/<building>/`, one
    per pano: a smooth floor boundary below the horizon and 0-3 spans of each
    W/D/O type, with one opening split by the pano seam now and then.

    The boundary's per-column uncertainty (px) is positive and varies along
    the row and between panos, so stitching's confidence-weighted fusion has
    walls to choose between. It comes from a generator of its own, so the
    other fields are those of the same seed without it."""
    rng = np.random.default_rng(seed)
    rng_unc = np.random.default_rng([seed, 1])
    out = Path(root) / "horizon_net" / building_id
    out.mkdir(parents=True)
    for complete in building_json["merger"]["floor_01"].values():
        for partial in complete.values():
            for pano in partial.values():
                stem = Path(pano["image_path"]).stem
                u = np.linspace(0, 2 * np.pi, 1024)
                boundary = 330 + 40 * np.sin(u * rng.integers(1, 4) + rng.uniform(0, 6)) + rng.normal(0, 2, 1024)
                feats = {}
                for kind in ("door", "window", "opening"):
                    spans = []
                    for _ in range(rng.integers(0, 4)):
                        s = rng.uniform(0.02, 0.9)
                        spans.append([s, s + rng.uniform(0.02, 0.08)])
                    feats[kind] = spans
                if rng.uniform() < 0.3:
                    feats["opening"] += [[0.001, 0.04], [0.96, 1.0]]
                pred = {
                    "image_height": 512,
                    "image_width": 1024,
                    "room_shape": {
                        "corners_in_uv": rng.uniform(0, 1, (8, 2)).tolist(),
                        "raw_predictions": {
                            "floor_boundary": boundary.tolist(),
                            "floor_boundary_uncertainty": boundary_uncertainty(rng_unc).tolist(),
                        },
                    },
                    "wall_features": feats,
                }
                (out / f"{stem}.json").write_text(json.dumps({"predictions": pred}))


def boundary_uncertainty(rng: np.random.Generator, width: int = 1024) -> np.ndarray:
    """A (width,) positive per-column floor-boundary uncertainty in px: a
    smooth wave around a per-pano level, with noise."""
    u = np.linspace(0, 2 * np.pi, width)
    level, amp = rng.uniform(3.0, 8.0), rng.uniform(0.5, 2.5)
    return level + amp * np.sin(u * rng.integers(1, 5) + rng.uniform(0, 6)) + np.abs(rng.normal(0, 0.5, width))


def write_seeded_vanishing_angles(root: Path, building_id: str, building_json: dict, seed: int) -> None:
    """`root/vanishing_angle/<building>.json`: an angle in [-3, 3) degrees per pano."""
    ids = sorted(pano_image_paths(building_json))
    angles = np.random.default_rng(seed).uniform(-3, 3, len(ids)).tolist()
    (Path(root) / "vanishing_angle").mkdir(parents=True, exist_ok=True)
    (Path(root) / "vanishing_angle" / f"{building_id}.json").write_text(json.dumps(dict(zip(map(str, ids), angles))))
