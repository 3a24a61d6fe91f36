"""CLI: verifier error analysis over Stage-C prediction dumps.

Consumes the batch_{i}.json files scripts/test.py-style evaluation writes
(same wire format the reference's salve/common/edge_classification.py:143
parses back) and reports, per floor:

  - hypothesis-level precision/recall at each confidence threshold;
  - EDGE-level losses: GT-positive pano pairs whose best hypothesis falls
    below threshold (Stage D consumes the max-probability hypothesis per
    pano pair, so these are the edges the pose graph actually loses);
  - false-negative / false-positive breakdowns by W/D/O type and
    identity/rotated configuration.

This is the analysis that produced ACCURACY_r02.json's error_analysis
section (v8 -> v9 procedural corpus changes); there is no reference
counterpart script — the reference eyeballs serialized visualizations
(scripts/visualize_edge_classifications.py) instead.

A copy of salve_tpu/cli/analyze_predictions.py (no JAX) on the standard
library's argparse, with the click original's flags; the analysis is host
code and reaches no card:

    python -m salve_tpu_torch.cli.analyze_predictions --preds_dir PREDS \
        [--hypotheses_save_root HYPS --raw_dataset_dir ZIND --building_id ID]

Note: y_hat_probs in batch_{i}.json is the ARGMAX-class probability
(reference scripts/test.py softmax-max convention), so
P(positive) = p when y_hat == 1 else 1 - p.
"""

from __future__ import annotations

import argparse
import glob
import json
import re
from collections import Counter
from pathlib import Path
from typing import List, Optional

from salve_tpu_torch.cli.args import UsageError, existing_path

_FNAME_RE = re.compile(
    r"pair_(\d+)___(door|window|opening)_(\d+)_(\d+)_(identity|rotated)"
    r"_(ceiling|floor)_rgb_(floor_\d+)_partial_room_(\d+)_pano_(\d+)"
)


def load_hypothesis_records(preds_dir: str, building_id: str | None = None):
    """Flatten batch_{i}.json dumps into per-hypothesis dicts with
    P(positive), W/D/O metadata, and the (pano0, pano1) edge key.

    building_id filters multi-building prediction dumps (the render's
    parent directory carries the building, as in _per_building_verifier)
    so per-floor analysis never mixes different buildings' floor_01s.
    """
    recs = []
    for fpath in sorted(glob.glob(str(Path(preds_dir) / "batch_*.json"))):
        with open(fpath) as f:
            d = json.load(f)
        for yh, yt, p, fp0, fp1 in zip(
            d["y_hat"], d["y_true"], d["y_hat_probs"], d["fp0"], d["fp1"]
        ):
            if building_id is not None and Path(fp0).parent.name != building_id:
                continue
            m0, m1 = _FNAME_RE.search(fp0), _FNAME_RE.search(fp1)
            if m0 is None or m1 is None:
                continue
            recs.append(
                {
                    "building": Path(fp0).parent.name,
                    "y_true": int(yt),
                    "p_pos": float(p) if yh == 1 else 1.0 - float(p),
                    "wdo": m0.group(2),
                    "wdo_idxs": (int(m0.group(3)), int(m0.group(4))),
                    "config": m0.group(5),
                    "floor": m0.group(7),
                    "rooms": (m0.group(8), m1.group(8)),
                    "edge": tuple(
                        sorted((int(m0.group(9)), int(m1.group(9))))
                    ),
                }
            )
    return recs


def classify_fp_families(
    records, hypotheses_save_root, raw_dataset_dir, building_id, threshold
):
    """Classify accepted false positives by their GT relative-pose error.

    Families (the Stage-D failure taxonomy ACCURACY_r03.json
    floor_01_forensics established by hand):
      - "slide":    rot within 3 deg but translation off by >= 0.3 m — a
                    wall-parallel W/D/O mispairing; self-consistent slides
                    are invisible to cycle filtering and poison the seam.
      - "rotation": rot error >= 3 deg (wrong configuration / wrong wall).
      - "near_miss": rot < 3 deg and trans < 0.3 m — labeled negative only
                    by the GT tolerance; harmless downstream.

    Requires the hypothesis JSONs and the GT pose graph; returns
    {floor: [fp detail dicts]} sorted by confidence.
    """
    import numpy as np

    from salve_tpu_torch.common import posegraph2d
    from salve_tpu_torch.geometry.sim2 import Sim2

    out = {}
    floors = sorted({r["floor"] for r in records})
    for floor in floors:
        gt = posegraph2d.get_gt_pose_graph(building_id, floor, raw_dataset_dir)
        fps = []
        for r in records:
            if r["floor"] != floor or r["y_true"] != 0 or r["p_pos"] < threshold:
                continue
            i1, i2 = r["edge"]
            fname = (
                f"{i1}_{i2}__{r['wdo']}_{r['wdo_idxs'][0]}_"
                f"{r['wdo_idxs'][1]}_{r['config']}.json"
            )
            fpath = (
                Path(hypotheses_save_root) / building_id / floor
                / "incorrect_alignment" / fname
            )
            if not fpath.exists() or i1 not in gt.nodes or i2 not in gt.nodes:
                continue
            S = Sim2.from_json(str(fpath))
            gt_rel = gt.nodes[i2].global_Sim2_local.inverse().compose(
                gt.nodes[i1].global_Sim2_local
            )
            rot_err = abs((S.theta_deg - gt_rel.theta_deg + 180) % 360 - 180)
            trans_err = float(
                np.linalg.norm(
                    S.translation / S.scale - gt_rel.translation / gt_rel.scale
                )
            )
            family = (
                "rotation"
                if rot_err >= 3.0
                else ("slide" if trans_err >= 0.3 else "near_miss")
            )
            fps.append(
                {
                    "edge": [i1, i2],
                    "p_pos": round(r["p_pos"], 4),
                    "wdo": f"{r['wdo']}_{r['wdo_idxs'][0]}_{r['wdo_idxs'][1]}",
                    "config": r["config"],
                    "rot_err_deg": round(float(rot_err), 2),
                    "trans_err_m": round(trans_err, 3),
                    "family": family,
                }
            )
        fps.sort(key=lambda d: -d["p_pos"])
        out[floor] = fps
    return out


def _components(nodes, edges):
    """Connected components (list of sorted lists, largest first)."""
    adj = {n: set() for n in nodes}
    for i, j in edges:
        adj.setdefault(i, set()).add(j)
        adj.setdefault(j, set()).add(i)
    seen, comps = set(), []
    for n in adj:
        if n in seen:
            continue
        stack, comp = [n], set()
        while stack:
            u = stack.pop()
            if u in comp:
                continue
            comp.add(u)
            stack.extend(adj[u] - comp)
        seen |= comp
        comps.append(sorted(comp))
    comps.sort(key=len, reverse=True)
    return comps


def analyze_floor(records, thresholds):
    """Hypothesis- and edge-level stats for one floor's records."""
    pos = [r for r in records if r["y_true"] == 1]
    neg = [r for r in records if r["y_true"] == 0]
    best_by_edge = {}
    for r in pos:
        cur = best_by_edge.get(r["edge"])
        if cur is None or r["p_pos"] > cur["p_pos"]:
            best_by_edge[r["edge"]] = r
    panos = sorted({p for r in records for p in r["edge"]})
    out = {
        "n_hypotheses": len(records),
        "n_gt_pos_hyps": len(pos),
        "n_gt_pos_edges": len(best_by_edge),
        "n_panos": len(panos),
        "thresholds": {},
    }
    for th in thresholds:
        tp = sum(1 for r in pos if r["p_pos"] >= th)
        fp = sum(1 for r in neg if r["p_pos"] >= th)
        lost = sorted(
            k for k, r in best_by_edge.items() if r["p_pos"] < th
        )
        fn_kinds = Counter(
            (r["wdo"], r["config"]) for r in pos if r["p_pos"] < th
        )
        fp_kinds = Counter(
            (r["wdo"], r["config"]) for r in neg if r["p_pos"] >= th
        )
        out["thresholds"][th] = {
            "hyp_recall": tp / max(len(pos), 1),
            "hyp_precision": tp / max(tp + fp, 1),
            "edges_lost": [list(k) for k in lost],
            "lost_edge_details": [
                {
                    "edge": list(k),
                    "best_p": round(best_by_edge[k]["p_pos"], 3),
                    "wdo": best_by_edge[k]["wdo"],
                    "config": best_by_edge[k]["config"],
                    "rooms": list(best_by_edge[k]["rooms"]),
                }
                for k in lost
            ],
            "fn_hyps_by_kind": {f"{w}/{c}": n for (w, c), n in fn_kinds.items()},
            "fp_hyps_by_kind": {f"{w}/{c}": n for (w, c), n in fp_kinds.items()},
        }
        # Graph-level consequence: components of the edge graph Stage D
        # would actually see at this threshold (ANY accepted hypothesis
        # keeps an edge alive, true or false), which panos are stranded
        # outside the largest component, and which lost GT-positive edges
        # are the BRIDGES whose acceptance would re-join components — the
        # audit that located building 0010's hub-pano failure (three
        # single-hypothesis crossings through one pano strand five panos).
        accepted_edges = {r["edge"] for r in records if r["p_pos"] >= th}
        comps = _components(panos, accepted_edges)
        comp_of = {p: ci for ci, comp in enumerate(comps) for p in comp}
        bridge_fns = [
            {
                "edge": list(k),
                "best_p": round(best_by_edge[k]["p_pos"], 3),
                "joins_component_sizes": sorted(
                    (len(comps[comp_of[k[0]]]), len(comps[comp_of[k[1]]]))
                ),
            }
            for k in sorted(best_by_edge)
            if best_by_edge[k]["p_pos"] < th
            and comp_of[k[0]] != comp_of[k[1]]
        ]
        out["thresholds"][th]["connectivity"] = {
            "n_components": len(comps),
            "component_sizes": [len(c) for c in comps],
            "pct_in_largest_cc": round(
                100.0 * len(comps[0]) / max(len(panos), 1), 1
            ) if comps else 0.0,
            "stranded_panos": sorted(
                p for p in panos if comps and comp_of[p] != 0
            ),
            "bridge_fn_edges": bridge_fns,
        }
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Verifier error analysis over Stage-C prediction dumps.")
    p.add_argument("--preds_dir", required=True, type=existing_path,
                   help="Directory holding batch_{i}.json prediction dumps.")
    p.add_argument("--thresholds", default="0.5,0.65,0.8,0.93",
                   help="Comma-separated confidence thresholds to analyze.")
    p.add_argument("--output_json", default=None, help="Optional path to also write the full report as JSON.")
    p.add_argument("--hypotheses_save_root", default=None, type=existing_path,
                   help="Stage-A hypothesis root: enables GT-pose false-positive family "
                        "classification (slide / rotation / near_miss).")
    p.add_argument("--raw_dataset_dir", default=None, type=existing_path,
                   help="ZInD root with GT pose graphs (required with --hypotheses_save_root).")
    p.add_argument("--building_id", default=None,
                   help="Filter multi-building prediction dumps to one building; also required with "
                        "--hypotheses_save_root for the FP-family classification.")
    p.add_argument("--fp_threshold", default=0.5, type=float,
                   help="Confidence threshold for the FP-family classification.")
    return p


def run_analyze_predictions(
    preds_dir: str,
    thresholds: str,
    output_json: str,
    hypotheses_save_root: str,
    raw_dataset_dir: str,
    building_id: str,
    fp_threshold: float,
) -> dict:
    """Print the analysis as the original's CLI does; returns the report."""
    ths = [float(t) for t in thresholds.split(",") if t]
    recs = load_hypothesis_records(preds_dir, building_id=building_id)
    report = {}
    for floor in sorted({r["floor"] for r in recs}):
        report[floor] = analyze_floor(
            [r for r in recs if r["floor"] == floor], ths
        )
    if hypotheses_save_root:
        if not (raw_dataset_dir and building_id):
            raise UsageError(
                "--hypotheses_save_root needs --raw_dataset_dir and "
                "--building_id"
            )
        families = classify_fp_families(
            recs, hypotheses_save_root, raw_dataset_dir, building_id,
            fp_threshold,
        )
        for floor, fps in families.items():
            report[floor]["fp_families"] = fps
            kinds = Counter(d["family"] for d in fps)
            print(
                f"{floor}: {len(fps)} FPs at conf>={fp_threshold}: "
                f"{dict(kinds)}"
            )
            for d in fps:
                if d["family"] != "near_miss":
                    print(
                        f"  {tuple(d['edge'])} p={d['p_pos']} {d['wdo']}/"
                        f"{d['config']}: rot {d['rot_err_deg']} deg, "
                        f"trans {d['trans_err_m']} m -> {d['family']}"
                    )
    for floor, fa in report.items():
        print(
            f"\n{floor}: {fa['n_hypotheses']} hyps, "
            f"{fa['n_gt_pos_hyps']} GT-pos over {fa['n_gt_pos_edges']} edges"
        )
        for th, st in fa["thresholds"].items():
            print(
                f"  conf {th}: hyp recall {st['hyp_recall']:.2f} "
                f"precision {st['hyp_precision']:.2f}; "
                f"edges lost {len(st['edges_lost'])}"
            )
            for d in st["lost_edge_details"]:
                print(
                    f"    lost {tuple(d['edge'])}: best_p={d['best_p']} "
                    f"{d['wdo']}/{d['config']} rooms {d['rooms']}"
                )
            conn = st.get("connectivity")
            if conn and conn["n_components"] > 1:
                print(
                    f"    components: {conn['component_sizes']} "
                    f"({conn['pct_in_largest_cc']}% in largest); "
                    f"stranded panos {conn['stranded_panos']}"
                )
                for b in conn["bridge_fn_edges"]:
                    print(
                        f"    bridge FN {tuple(b['edge'])}: "
                        f"best_p={b['best_p']} joins component sizes "
                        f"{b['joins_component_sizes']}"
                    )
            if st["fn_hyps_by_kind"]:
                print(f"    FN by kind: {st['fn_hyps_by_kind']}")
            if st["fp_hyps_by_kind"]:
                print(f"    FP by kind: {st['fp_hyps_by_kind']}")
    if output_json:
        with open(output_json, "w") as f:
            json.dump(report, f, indent=1)
        print(f"\nwrote {output_json}")
    return report


def main(argv: Optional[List[str]] = None) -> dict:
    parser = build_parser()
    args = parser.parse_args(argv)
    try:
        return run_analyze_predictions(**vars(args))
    except UsageError as e:
        parser.error(str(e))


if __name__ == "__main__":
    main()
