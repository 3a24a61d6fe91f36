"""CLI: generate all pairwise W/D/O alignment hypotheses for a ZInD split.

Flag-compatible with the reference scripts/export_alignment_hypotheses.py;
a copy of salve_tpu/cli/export_alignment_hypotheses.py with `--device`
(default: the CUDA card; `--device cpu` runs inferred mode's batched product
on the CPU). GT mode runs on the host either way. The parser is the standard
library's argparse, so the CLI starts where only torch, numpy and scipy are
installed:

    python -m salve_tpu_torch.cli.export_alignment_hypotheses --raw_dataset_dir ZIND \
        --hypotheses_save_root OUT --wdo_source ground_truth --split test
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Optional

from salve_tpu_torch.cli.args import existing_path
from salve_tpu_torch.hypotheses.export import export_alignment_hypotheses_to_json


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Generate pairwise W/D/O alignment hypotheses for a ZInD split.")
    p.add_argument("--raw_dataset_dir", type=existing_path, required=True,
                   help="Path to where ZInD dataset is stored on disk (after download from Bridge API).")
    p.add_argument("--num_processes", type=int, default=32,
                   help="Number of worker processes; each processes one building at a time.")
    p.add_argument("--hypotheses_save_root", type=str, required=True,
                   help="Directory where JSON files with alignment hypotheses will be saved to.")
    p.add_argument("--wdo_source", choices=["horizon_net", "ground_truth"], required=True,
                   help="Where to pull W/D/O and layout (inferred from HorizonNet, or annotated ground truth).")
    p.add_argument("--split", choices=["train", "val", "test"], required=True,
                   help="ZInD dataset split to generate alignment hypotheses for.")
    p.add_argument("--mhnet_predictions_data_root", type=str, default=None,
                   help="Path to directory containing HorizonNet predictions.")
    p.add_argument("--building_id", type=str, default=None,
                   help="Optional single building ID to process (overrides --split selection).")
    p.add_argument("--device", type=str, default="cuda",
                   help="Where inferred mode's batched hypothesis product runs ('cuda' or 'cpu'; default: cuda).")
    return p


def run_export_alignment_hypotheses(
    raw_dataset_dir: str,
    num_processes: int,
    hypotheses_save_root: str,
    wdo_source: str,
    split: str,
    mhnet_predictions_data_root: Optional[str],
    building_id: Optional[str],
    device: str,
) -> None:
    export_alignment_hypotheses_to_json(
        num_processes=num_processes,
        raw_dataset_dir=raw_dataset_dir,
        hypotheses_save_root=hypotheses_save_root,
        use_inferred_wdos_layout=wdo_source == "horizon_net",
        dataset_split=split,
        mhnet_predictions_data_root=mhnet_predictions_data_root,
        building_ids=[building_id] if building_id else None,
        device=device,
    )


def main(argv: Optional[List[str]] = None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.wdo_source == "horizon_net" and (
        args.mhnet_predictions_data_root is None or not Path(args.mhnet_predictions_data_root).exists()
    ):
        parser.error("--mhnet_predictions_data_root must point to an existing directory "
                     "when --wdo_source=horizon_net.")
    run_export_alignment_hypotheses(**vars(args))


if __name__ == "__main__":
    main()
