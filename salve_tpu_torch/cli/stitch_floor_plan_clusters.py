"""CLI: stitch floorplans from cluster-localization JSONs, scored vs GT.

Parity: scripts/stitch_floor_plan.py (the reference's original stitch
driver — WIP there with a live pdb.set_trace() at :73; completed here via
salve_tpu.stitching.cluster_stitching). Same flags. For the
run_sfm-output-driven flow use salve_tpu.cli.stitch_floor_plan
(parity: scripts/stitch_floor_plan_new.py).

A copy of salve_tpu/cli/stitch_floor_plan_clusters.py (no JAX), on argparse
instead of click, with `--device` (default: the CUDA card) for the rasters.
It writes `score.json` and each cluster's `final.png` (a side figure,
`utils/plotting.py`: left out where matplotlib is absent).

    python -m salve_tpu_torch.cli.stitch_floor_plan_clusters -o OUT \\
        --est-localization-fpath cluster_pred.json --hnet-pred-dir PREDS \\
        --path-gt-floor-map floor_map.json --device cpu
"""

from __future__ import annotations

import argparse
import json
import logging
from typing import List, Optional

from salve_tpu_torch.cli.args import existing_path
from salve_tpu_torch.stitching.cluster_stitching import stitch_clusters


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Run floorplan stitching using previously localized cluster poses.")
    p.add_argument("-o", "--output-dir", dest="output_dir", type=str, required=True,
                   help="Path to directory where stitched outputs will be saved to.")
    p.add_argument("--est-localization-fpath", dest="est_localization_fpath", type=existing_path, required=True,
                   help="JSON with estimated pano poses per cluster (SALVe + global optimization output).")
    p.add_argument("--hnet-pred-dir", dest="hnet_pred_dir", type=existing_path, required=True,
                   help="Directory with per-pano HorizonNet room-shape and DWO prediction JSONs.")
    p.add_argument("--path-gt-floor-map", dest="path_gt_floor_map", type=existing_path, required=True,
                   help="Path to the GT ZInD floor_map JSON.")
    p.add_argument("--device", type=str, default="cuda",
                   help="Where the rasters run ('cuda' or 'cpu'; default: cuda).")
    return p


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    scores = stitch_clusters(
        est_localization_fpath=args.est_localization_fpath,
        hnet_pred_dir=args.hnet_pred_dir,
        path_gt_floor_map=args.path_gt_floor_map,
        output_dir=args.output_dir,
        device=args.device,
    )
    print(json.dumps(scores, indent=2))


if __name__ == "__main__":
    main()
