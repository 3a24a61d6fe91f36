"""Stage-A exporter: generate + label + serialize alignment hypotheses per building.

On-disk contract (bit-compatible with the reference,
scripts/export_alignment_hypotheses.py:85-90,206,228-237):

    {hyp_root}/{building}/{floor}/gt_alignment_exact/{i1}_{i2}.json
    {hyp_root}/{building}/{floor}/gt_alignment_approx/
        {i1}_{i2}__{object}_{i}_{j}_{configuration}.json
    {hyp_root}/{building}/{floor}/incorrect_alignment/...same grammar...

Each JSON holds a Sim(2) as {"R": [4], "t": [2], "s": float}.

Parallelism: the reference forks one process per building; here buildings are
simply a host-side work loop (the per-candidate math is vectorized/closed-form
rather than per-candidate C++ calls, so one host core does a building in
roughly the time the reference spends marshalling into GTSAM).

A copy of salve_tpu/hypotheses/export.py with a `device` (None: the CUDA
card; raises without one) threaded to the batched product of inferred mode.
GT mode runs on the host only, as in the reference.
"""

from __future__ import annotations

import concurrent.futures as cf
import functools
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

import salve_tpu_torch.dataset.hnet_prediction_loader as hnet_prediction_loader
import salve_tpu_torch.hypotheses.wdo_alignment as wdo_alignment
import salve_tpu_torch.utils.io as io_utils
from salve_tpu_torch.common.alignment_hypothesis import prune_to_unique_sim2_objs
from salve_tpu_torch.common.pano_data import FloorData
from salve_tpu_torch.dataset.zind_partition import DATASET_SPLITS
from salve_tpu_torch.device import DeviceLike, resolve_device
from salve_tpu_torch.geometry.sim2 import Sim2
from salve_tpu_torch.hypotheses.batched import align_floor_pairs_batched
from salve_tpu_torch.hypotheses.wdo_alignment import AlignTransformType


def save_Sim2(save_fpath: str, i2Ti1: Sim2) -> None:
    """Serialize a Sim(2) in the reference wire format."""
    io_utils.save_json_file(
        save_fpath,
        {
            "R": i2Ti1.rotation.flatten().tolist(),
            "t": i2Ti1.translation.flatten().tolist(),
            "s": i2Ti1.scale,
        },
    )


def export_single_building_wdo_alignment_hypotheses(
    hypotheses_save_root: str,
    building_id: str,
    json_annot_fpath: str,
    raw_dataset_dir: str,
    use_inferred_wdos_layout: bool,
    mhnet_predictions_data_root: Optional[str] = None,
    device: DeviceLike = None,
) -> Optional[Dict[str, List[bool]]]:
    """Generate and save labeled hypotheses for every pano pair of every floor.

    Returns per-floor GT-validity flags (diagnostic), or None if inputs missing.
    Inferred mode computes each floor's hypothesis product on `device`.
    """
    dev = resolve_device(device)
    if use_inferred_wdos_layout:
        floor_pose_graphs = hnet_prediction_loader.load_inferred_floor_pose_graphs(
            building_id=building_id,
            raw_dataset_dir=raw_dataset_dir,
            predictions_data_root=mhnet_predictions_data_root,
        )
        if floor_pose_graphs is None:
            return None

    floor_map_json = io_utils.read_json_file(json_annot_fpath)
    if "merger" not in floor_map_json:
        print(f"Building {building_id} does not have `merger` data, skipping...")
        return None

    floor_gt_is_valid: Dict[str, List[bool]] = defaultdict(list)

    for floor_id, floor_data in floor_map_json["merger"].items():
        fd = FloorData.from_json(floor_data, floor_id)
        pano_dict = {pano_obj.id: pano_obj for pano_obj in fd.panos}
        if use_inferred_wdos_layout:
            pano_dict_inferred = floor_pose_graphs[floor_id].nodes

        pano_ids = sorted(pano_dict.keys())

        # Pre-compute the floor's full hypothesis product on device
        # (inferred mode only; GT mode needs the host freespace check).
        batched_hypotheses = {}
        if use_inferred_wdos_layout:
            floor_pairs = [
                (i1, i2)
                for i1 in pano_ids
                for i2 in pano_ids
                if i1 < i2
                and not (building_id == "0006" and 7 in (i1, i2))
                and i1 in pano_dict_inferred
                and i2 in pano_dict_inferred
            ]
            batched_hypotheses = align_floor_pairs_batched(
                pano_dict_inferred, floor_pairs, use_inferred_wdos_layout=True, device=dev
            )

        n_valid = n_invalid = 0
        for i1 in pano_ids:
            for i2 in pano_ids:
                if i1 >= i2:
                    continue
                # ZInD annotation error: building 0006 pano 7 is mislabeled.
                if building_id == "0006" and 7 in (i1, i2):
                    continue

                visibly_adjacent = wdo_alignment.are_visibly_adjacent(
                    pano_dict[i1], pano_dict[i2]
                )

                if use_inferred_wdos_layout:
                    for i in (i1, i2):
                        if i not in pano_dict_inferred:
                            raise ValueError(
                                f"MHNet predictions for pano {i} are missing for Building {building_id}."
                            )
                    # Inferred mode is the production path: the whole floor's
                    # (pair x wdo x wdo x config) product was pre-computed in
                    # one device call (see below); look up this pair's slice.
                    hypotheses = batched_hypotheses.get((i1, i2))
                    if hypotheses is None:
                        hypotheses, _ = wdo_alignment.align_rooms_by_wd(
                            pano_dict_inferred[i1],
                            pano_dict_inferred[i2],
                            transform_type=AlignTransformType.SE2,
                            use_inferred_wdos_layout=True,
                        )
                    num_invalid = 0
                else:
                    hypotheses, num_invalid = wdo_alignment.align_rooms_by_wd(
                        pano_dict[i1],
                        pano_dict[i2],
                        transform_type=AlignTransformType.SE2,
                        use_inferred_wdos_layout=False,
                    )
                n_valid += len(hypotheses)
                n_invalid += num_invalid

                # GT relative pose: i2Ti1 = (wTi2)^-1 * wTi1.
                i2Ti1_gt = (
                    pano_dict[i2].global_Sim2_local.inverse().compose(
                        pano_dict[i1].global_Sim2_local
                    )
                )
                if visibly_adjacent:
                    save_Sim2(
                        f"{hypotheses_save_root}/{building_id}/{floor_id}/gt_alignment_exact/{i1}_{i2}.json",
                        i2Ti1_gt,
                    )
                    assert np.allclose(
                        i2Ti1_gt.rotation.T @ i2Ti1_gt.rotation, np.eye(2), atol=1e-6
                    )

                labels = []
                for ah in prune_to_unique_sim2_objs(hypotheses):
                    if wdo_alignment.obj_almost_equal(ah.i2Ti1, i2Ti1_gt, ah.wdo_alignment_object):
                        label, save_dirname = "aligned", "gt_alignment_approx"
                    else:
                        label, save_dirname = "misaligned", "incorrect_alignment"
                    labels.append(label)
                    fname = (
                        f"{i1}_{i2}__{ah.wdo_alignment_object}_{ah.i1_wdo_idx}_"
                        f"{ah.i2_wdo_idx}_{ah.configuration}.json"
                    )
                    save_Sim2(
                        f"{hypotheses_save_root}/{building_id}/{floor_id}/{save_dirname}/{fname}",
                        ah.i2Ti1,
                    )

                gt_valid = ("aligned" in labels) if visibly_adjacent else ("aligned" not in labels)
                floor_gt_is_valid[floor_id].append(gt_valid)

        print(
            f"Building {building_id} {floor_id}: {n_valid} valid / {n_invalid} invalid configurations"
        )

    for floor_id, flags in floor_gt_is_valid.items():
        print(
            f"Building {building_id} {floor_id}: {np.mean(flags):.2f} GT is-valid frac. "
            f"over {len(flags)} alignment pairs."
        )
    return dict(floor_gt_is_valid)


def export_alignment_hypotheses_to_json(
    num_processes: int,
    raw_dataset_dir: str,
    hypotheses_save_root: str,
    use_inferred_wdos_layout: bool,
    dataset_split: str,
    mhnet_predictions_data_root: Optional[str],
    building_ids: Optional[List[str]] = None,
    device: Optional[str] = None,
) -> None:
    """Export hypotheses for all buildings of a split (process pool over buildings).

    `device` names where inferred mode's batched product runs (None: the
    CUDA card); each worker process resolves it for itself.
    """
    if building_ids is None:
        building_ids = sorted(DATASET_SPLITS[dataset_split])

    run = functools.partial(
        _export_one_building,
        hypotheses_save_root=hypotheses_save_root,
        raw_dataset_dir=raw_dataset_dir,
        use_inferred_wdos_layout=use_inferred_wdos_layout,
        mhnet_predictions_data_root=mhnet_predictions_data_root,
        device=device,
    )
    if num_processes > 1:
        # Module-level fn + functools.partial: picklable for the process pool
        # (a local closure is not). Spawn-context workers: a process that
        # has initialised CUDA must never fork, and each spawned worker
        # resolves the device (by default the card) for itself.
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        with cf.ProcessPoolExecutor(max_workers=num_processes, mp_context=ctx) as pool:
            list(pool.map(run, building_ids))
    else:
        for b in building_ids:
            run(b)


def _export_one_building(
    building_id: str,
    hypotheses_save_root: str,
    raw_dataset_dir: str,
    use_inferred_wdos_layout: bool,
    mhnet_predictions_data_root: Optional[str],
    device: Optional[str],
) -> None:
    export_single_building_wdo_alignment_hypotheses(
        hypotheses_save_root=hypotheses_save_root,
        building_id=building_id,
        json_annot_fpath=f"{raw_dataset_dir}/{building_id}/zind_data.json",
        raw_dataset_dir=raw_dataset_dir,
        use_inferred_wdos_layout=use_inferred_wdos_layout,
        mhnet_predictions_data_root=mhnet_predictions_data_root,
        device=device,
    )
