"""CLI: generate all pairwise W/D/O alignment hypotheses for a ZInD split.

Flag-compatible with the reference scripts/export_alignment_hypotheses.py;
a copy of salve_tpu/cli/export_alignment_hypotheses.py with `--device`
(default: the CUDA card; `--device cpu` runs inferred mode's batched product
on the CPU). GT mode runs on the host either way.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import click

from salve_tpu_torch.hypotheses.export import export_alignment_hypotheses_to_json


@click.command(help="Generate pairwise W/D/O alignment hypotheses for a ZInD split.")
@click.option(
    "--raw_dataset_dir",
    type=click.Path(exists=True),
    required=True,
    help="Path to where ZInD dataset is stored on disk (after download from Bridge API).",
)
@click.option(
    "--num_processes",
    type=int,
    default=32,
    help="Number of worker processes; each processes one building at a time.",
)
@click.option(
    "--hypotheses_save_root",
    type=str,
    required=True,
    help="Directory where JSON files with alignment hypotheses will be saved to.",
)
@click.option(
    "--wdo_source",
    type=click.Choice(["horizon_net", "ground_truth"]),
    required=True,
    help="Where to pull W/D/O and layout (inferred from HorizonNet, or annotated ground truth).",
)
@click.option(
    "--split",
    type=click.Choice(["train", "val", "test"]),
    required=True,
    help="ZInD dataset split to generate alignment hypotheses for.",
)
@click.option(
    "--mhnet_predictions_data_root",
    type=str,
    default=None,
    required=False,
    help="Path to directory containing HorizonNet predictions.",
)
@click.option(
    "--building_id",
    type=str,
    default=None,
    required=False,
    help="Optional single building ID to process (overrides --split selection).",
)
@click.option(
    "--device",
    type=str,
    default="cuda",
    show_default=True,
    help="Where inferred mode's batched hypothesis product runs ('cuda' or 'cpu').",
)
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
    use_inferred_wdos_layout = wdo_source == "horizon_net"
    if use_inferred_wdos_layout:
        if mhnet_predictions_data_root is None or not Path(mhnet_predictions_data_root).exists():
            raise click.UsageError(
                "--mhnet_predictions_data_root must point to an existing directory "
                "when --wdo_source=horizon_net."
            )
    export_alignment_hypotheses_to_json(
        num_processes=num_processes,
        raw_dataset_dir=raw_dataset_dir,
        hypotheses_save_root=hypotheses_save_root,
        use_inferred_wdos_layout=use_inferred_wdos_layout,
        dataset_split=split,
        mhnet_predictions_data_root=mhnet_predictions_data_root,
        building_ids=[building_id] if building_id else None,
        device=device,
    )


if __name__ == "__main__":
    run_export_alignment_hypotheses()
