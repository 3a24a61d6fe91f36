"""Floor-level batched W/D/O alignment (Stage A hot loop on the card).

Port of salve_tpu/hypotheses/batched.py. The reference's Stage A inner loop
(salve/utils/wdo_alignment.py:107 inside
scripts/export_alignment_hypotheses.py:160-262) calls gtsam.Pose2.Align once
per (pair, wdo1, wdo2, configuration). Here the full (pair x wdo x wdo x
configuration) product of a floor is one batched tensor computation on the
card: the closed-form 2D Procrustes fit and the width-ratio test are masked
ops over padded W/D/O tables.

The rotated configuration (WDO.get_rotated_version, endpoints swapped) is a
fixed index permutation of the 5-point outline, so both configurations ride
the same batch. The tables are padded to the floor's largest W/D/O count;
the reference's further power-of-two padding (`_bucket`) only bounded XLA's
compile count and changes no output, so the port drops it.

Which candidates survive depends only on the float32 width test
min(w1, w2) / max(w1, w2) >= float32(min_ratio): a true IEEE division (also
on the card) against the float32 constant, so the mask is bit-identical to
the reference's. The device R and t are not written: each survivor's
transform is refit on the host in float64 from its two W/D/O outlines, as
the reference does.

GT mode's freespace-penetration check (polygon containment of interpolated
boundaries) stays host-side in the per-pair path; this module serves
inferred mode, as in the reference.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from salve_tpu_torch.common.alignment_hypothesis import AlignmentHypothesis
from salve_tpu_torch.common.pano_data import PanoData
from salve_tpu_torch.device import DeviceLike, resolve_device
from salve_tpu_torch.geometry.point_alignment import align_points_SE2, fit_se2
from salve_tpu_torch.geometry.sim2 import Sim2
from salve_tpu_torch.hypotheses.wdo_alignment import (
    MIN_ALLOWED_GT_WDO_WIDTH_RATIO,
    MIN_ALLOWED_INFERRED_WDO_WIDTH_RATIO,
)


_TYPES = ("door", "window", "opening")
# Parity: doors/openings try identity+rotated; windows identity only.
_NUM_CONFIGS = {"door": 2, "window": 1, "opening": 2}

FloorTables = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _pack_type(
    pano_dict: Dict[int, PanoData], pano_ids: List[int], attr: str, w_max: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Padded (P, w_max, 5, 2) outlines + (P, w_max) widths/valid for one type."""
    P = len(pano_ids)
    pts = np.zeros((P, w_max, 5, 2), dtype=np.float32)
    widths = np.ones((P, w_max), dtype=np.float32)
    valid = np.zeros((P, w_max), dtype=bool)
    for k, pid in enumerate(pano_ids):
        wdos = getattr(pano_dict[pid], attr) or []
        for w, wdo in enumerate(wdos[:w_max]):
            pts[k, w] = wdo.polygon_vertices_local_3d[:, :2]
            widths[k, w] = wdo.width
            valid[k, w] = True
    return pts, widths, valid


def floor_tables(
    pano_dict: Dict[int, PanoData], pairs: List[Tuple[int, int]], obj_type: str, device: torch.device
) -> Optional[FloorTables]:
    """(pts1, w1, v1, pts2, w2, v2) of one W/D/O type on `device`, one row a
    pair, or None when no pano of the floor has that type."""
    attr = obj_type + "s"
    w_max = max((len(getattr(pd, attr) or []) for pd in pano_dict.values()), default=0)
    if w_max == 0:
        return None
    pano_ids = sorted(pano_dict.keys())
    id2row = {pid: k for k, pid in enumerate(pano_ids)}
    tables = [torch.as_tensor(a, device=device) for a in _pack_type(pano_dict, pano_ids, attr, w_max)]
    rows1 = torch.as_tensor([id2row[i1] for i1, _ in pairs], device=device)
    rows2 = torch.as_tensor([id2row[i2] for _, i2 in pairs], device=device)
    return tuple(a[rows1] for a in tables) + tuple(a[rows2] for a in tables)


def _product_se2_fits(
    pts1: torch.Tensor,  # (B, W, 5, 2) pano-1 outlines per edge
    w1: torch.Tensor,  # (B, W) widths
    v1: torch.Tensor,  # (B, W) valid
    pts2: torch.Tensor,  # (B, W, 5, 2)
    w2: torch.Tensor,
    v2: torch.Tensor,
    min_width_ratio: torch.Tensor,  # float32 scalar
    num_configs: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All (wdo1 x wdo2 x config) SE(2) fits + width masks for B edges.

    Returns R (B,W,W,C,2,2), t (B,W,W,C,2), valid (B,W,W,C).
    """
    # Configurations of pano-2 outlines: identity, then rotated. An outline
    # is [p1, p1, p2, p2, p1] (polygon_vertices_local_3d dropped to xy); its
    # rotated version [p2, p2, p1, p1, p2] is the gather [2, 3, 0, 1, 2],
    # taken as slices: indexing with a host list would copy the index to
    # the card and wait for it.
    configs = [pts2]
    if num_configs == 2:
        configs.append(torch.cat([pts2[:, :, 2:4], pts2[:, :, 0:2], pts2[:, :, 2:3]], dim=2))
    p2 = torch.stack(configs, dim=2)  # (B, W, C, 5, 2)

    # Broadcast product: a = pano2 (target frame), b = pano1 (source frame).
    a = p2[:, None, :, :, :, :]  # (B, 1, W, C, 5, 2)
    b = pts1[:, :, None, None, :, :]  # (B, W, 1, 1, 5, 2)
    a, b = torch.broadcast_tensors(a, b)
    R, t = fit_se2(a, b)  # i2Ti1 per candidate

    ratio = torch.minimum(w1[:, :, None], w2[:, None, :]) / torch.maximum(w1[:, :, None], w2[:, None, :])
    ok = (v1[:, :, None] & v2[:, None, :] & (ratio >= min_width_ratio))[..., None]
    ok = ok.expand(R.shape[:4])
    return R, t, ok


def align_floor_pairs_batched(
    pano_dict: Dict[int, PanoData],
    pairs: List[Tuple[int, int]],
    use_inferred_wdos_layout: bool,
    device: DeviceLike = None,
) -> Dict[Tuple[int, int], List[AlignmentHypothesis]]:
    """SE(2) alignment hypotheses for every pano pair of a floor, on `device`
    (None: the CUDA card; raises without one).

    Equivalent to calling wdo_alignment.align_rooms_by_wd(transform_type=SE2)
    per pair, minus the GT-mode freespace check. Hypotheses of a pair come in
    the reference's order: types door, window, opening; then row-major over
    (wdo of pano 1, wdo of pano 2, configuration).
    """
    dev = resolve_device(device)
    if not pairs:
        return {}
    min_ratio = (
        MIN_ALLOWED_INFERRED_WDO_WIDTH_RATIO if use_inferred_wdos_layout else MIN_ALLOWED_GT_WDO_WIDTH_RATIO
    )
    min_ratio_f32 = torch.tensor(min_ratio, dtype=torch.float32, device=dev)

    out: Dict[Tuple[int, int], List[AlignmentHypothesis]] = {p: [] for p in pairs}
    for obj_type in _TYPES:
        tables = floor_tables(pano_dict, pairs, obj_type, dev)
        if tables is None:
            continue
        num_configs = _NUM_CONFIGS[obj_type]
        _, _, ok = _product_se2_fits(*tables, min_ratio_f32, num_configs)
        ok = ok.cpu().numpy()

        attr = obj_type + "s"
        config_names = ["identity", "rotated"][:num_configs]
        for e, (i1, i2) in enumerate(pairs):
            for wi, wj, c in np.argwhere(ok[e]):
                out[(i1, i2)].append(
                    AlignmentHypothesis(
                        # The device product (f32) decides which candidates
                        # survive; the written transform is refit on the host
                        # in f64 from the two W/D/O outlines, as the
                        # reference's per-candidate path computes it.
                        i2Ti1=_host_refit_se2(
                            pano_dict[i2], pano_dict[i1], attr, int(wj), int(wi), config_names[c]
                        ),
                        wdo_alignment_object=obj_type,
                        i1_wdo_idx=int(wi),
                        i2_wdo_idx=int(wj),
                        configuration=config_names[c],
                    )
                )
    return out


def _host_refit_se2(
    pano2: PanoData, pano1: PanoData, attr: str, wj: int, wi: int, configuration: str
) -> Sim2:
    """f64 closed-form SE(2) refit of one surviving candidate (host path parity)."""
    pano1_wd = getattr(pano1, attr)[wi]
    pano2_wd = getattr(pano2, attr)[wj]
    if configuration == "rotated":
        pano2_wd = pano2_wd.get_rotated_version()
    i2Ti1, _ = align_points_SE2(
        pano2_wd.polygon_vertices_local_3d[:, :2],
        pano1_wd.polygon_vertices_local_3d[:, :2],
    )
    return i2Ti1
