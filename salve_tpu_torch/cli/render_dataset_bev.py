"""CLI: render aligned BEV texture maps or rasterized layouts.

Port of salve_tpu/cli/render_dataset_bev.py on argparse, with the
reference's flags and `--device`. As there, --num_processes sets the host IO
threads and --multiprocess_building_panos is accepted for flag parity: the
pixel work runs in device batches, not forked workers.

    python -m salve_tpu_torch.cli.render_dataset_bev --raw_dataset_dir ZIND \
        --depth_save_root DEPTH --hypotheses_save_root HYPS --bev_save_root OUT \
        --building_id 0000 [--layout_save_root LAYOUTS --mhnet_predictions_data_root MHNET] [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
from typing import List, Optional

from salve_tpu_torch.cli.args import boolean, existing_path
from salve_tpu_torch.rendering.dataset_renderer import DEFAULT_BATCH_SIZE, render_pairs


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Render BEV texture maps or rasterized layouts for alignment hypotheses.")
    p.add_argument("--raw_dataset_dir", type=existing_path, required=True,
                   help="Path to where ZInD dataset is stored on disk.")
    p.add_argument("--num_processes", type=int, default=15, help="Host IO worker threads.")
    p.add_argument("--depth_save_root", type=str, required=True,
                   help="Path to where depth maps are stored (or will be saved to, if not computed yet).")
    p.add_argument("--hypotheses_save_root", type=existing_path, required=True,
                   help="Path to where alignment hypotheses are saved on disk.")
    p.add_argument("--bev_save_root", type=str, required=True, help="Directory where BEV texture maps should be written.")
    p.add_argument("--split", choices=["train", "val", "test"], default=None)
    p.add_argument("--layout_save_root", type=str, default=None,
                   help="If provided, rasterized layouts are rendered (instead of RGB texture maps).")
    p.add_argument("--building_id", type=str, default=None)
    p.add_argument("--multiprocess_building_panos", type=boolean, default=True,
                   help="Accepted for flag parity; batching is automatic.")
    p.add_argument("--mhnet_predictions_data_root", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=DEFAULT_BATCH_SIZE, help="Hypothesis pairs per device batch.")
    warp = p.add_mutually_exclusive_group()
    warp.add_argument("--use_warp_renders", dest="use_warp_renders", action="store_true", default=None,
                      help="Render img1 as a Sim(2) warp of a per-pano identity bank instead of a full "
                           "per-hypothesis splat (default: on for the CUDA card, off on the CPU).")
    warp.add_argument("--no_use_warp_renders", dest="use_warp_renders", action="store_false", default=None)
    p.add_argument("--device", type=str, default="cuda", help="Where the renders run ('cuda' or 'cpu'; default: cuda).")
    return p


def run_render_dataset_bev(
    raw_dataset_dir: str,
    num_processes: int,
    depth_save_root: str,
    hypotheses_save_root: str,
    bev_save_root: str,
    split: Optional[str],
    layout_save_root: Optional[str],
    building_id: Optional[str],
    multiprocess_building_panos: bool,
    mhnet_predictions_data_root: Optional[str],
    batch_size: int,
    use_warp_renders: Optional[bool],
    device: str,
) -> int:
    logging.basicConfig(level=logging.INFO)
    render_modalities = ["rgb_texture"] if layout_save_root is None else ["layout"]
    n = render_pairs(
        depth_save_root=depth_save_root,
        bev_save_root=bev_save_root,
        raw_dataset_dir=raw_dataset_dir,
        hypotheses_save_root=hypotheses_save_root,
        layout_save_root=layout_save_root,
        render_modalities=render_modalities,
        split=split,
        building_id=building_id,
        mhnet_predictions_data_root=mhnet_predictions_data_root,
        batch_size=batch_size,
        use_warp=use_warp_renders,
        device=device,
    )
    print(f"Rendered {n} pair images.")
    return n


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    run_render_dataset_bev(**vars(args))


if __name__ == "__main__":
    main()
