"""Fused Stage B+C inference: render and verify hypotheses on the card.

Port of salve_tpu/pipeline/fused_inference.py. For each hypothesis batch:
render ceiling+floor texture-map pairs from the device-resident pano bank,
quantize to u8 (the domain the verifier was trained on), resize to the eval
resolution and score with the early-fusion CNN, with no image files and no
host round trip of images. Output is the per-hypothesis (y_hat, prob)
record Stage D consumes.

Kernels on this path: B1 (splat) and B2 (fill + mask) for the identity and
warp banks, and in warp mode B3 (shear warp), one launch a batch for the
ceiling and the floor; B1 and B2 per hypothesis in direct mode.

On a mesh of N ranks (parallel/mesh.py; salve_tpu's shard_map scorer,
`make_fused_score_fn_sharded`) every rank renders the floor's banks itself,
scores its batch_size / N rows of each padded batch with the unmodified
one-card body, and the (y_hat, prob) of each batch are all-gathered, so
every rank returns the whole ordered list. No other collective runs.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from salve_tpu_torch.device import DeviceLike, resolve_device
from salve_tpu_torch.ops.backproject import CEILING_Z_RANGE, FLOOR_Z_RANGE
from salve_tpu_torch.parallel.mesh import Mesh, all_gather_rows, shard_batch
from salve_tpu_torch.rendering.bev_pair import (
    BEVRenderConfig,
    HOHO_S_ZIND_SCALE_FACTOR,
    render_identity_batched,
    render_transformed_batched,
)
from salve_tpu_torch.training import transforms
from salve_tpu_torch.training.config import TrainingConfig


class ScoredHypothesis(NamedTuple):
    """Verifier verdict for one alignment hypothesis."""

    i1: int
    i2: int
    wdo_pair_uuid: str
    configuration: str
    y_hat: int
    prob: float  # probability of the predicted class


@torch.no_grad()
def score_batch(
    model: torch.nn.Module,
    cfg: TrainingConfig,
    render_cfg: BEVRenderConfig,
    use_warp_renders: bool,
    depths: torch.Tensor,
    rgbs: torch.Tensor,
    bank_ceil: torch.Tensor,
    bank_floor: torch.Tensor,
    i1_idx: torch.Tensor,
    i2_idx: torch.Tensor,
    rotations: torch.Tensor,
    translations: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused render -> preprocess -> verify batch (JAX `_make_score_body`).

    In warp mode `depths`/`rgbs` hold the extended packed rgb888 warp banks
    of the ceiling and the floor instead of the raw pano banks.
    """
    if use_warp_renders:
        from salve_tpu_torch.ops.warp import warp_banks_auto

        t_scaled = translations * HOHO_S_ZIND_SCALE_FACTOR
        ceil1, floor1 = warp_banks_auto(
            (depths, rgbs), rotations, t_scaled, render_cfg.img_px, render_cfg.meters_per_px,
            bank_idx=i1_idx,
        )
    else:
        d1, c1 = depths[i1_idx], rgbs[i1_idx]
        ceil1 = render_transformed_batched(d1, c1, rotations, translations, CEILING_Z_RANGE, render_cfg)
        floor1 = render_transformed_batched(d1, c1, rotations, translations, FLOOR_Z_RANGE, render_cfg)
    # Pano 2 is rendered in its own frame: it comes from the identity bank.
    ceil2, floor2 = bank_ceil[i2_idx], bank_floor[i2_idx]

    batch = torch.stack([ceil1, ceil2, floor1, floor2], dim=1)  # (B, 4, h, w, 3) u8
    batch = transforms.resize_batch(batch, cfg.resize_h, cfg.resize_w)
    batch = transforms.preprocess_eval(batch, cfg.train_h, cfg.train_w)
    logits = model([batch[:, i].permute(0, 3, 1, 2) for i in range(4)])
    probs = torch.softmax(logits, dim=1)
    y_hat = torch.argmax(logits, dim=1)
    return y_hat, probs[torch.arange(probs.shape[0], device=probs.device), y_hat]


@torch.no_grad()
def build_banks(
    depths: torch.Tensor, rgbs: torch.Tensor, render_cfg: BEVRenderConfig, use_warp_renders: bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The per-floor banks: (source 1, source 2, identity ceiling, identity floor).

    Identity-frame BEV renders, one per pano per surface. In warp mode the
    two sources are the extended packed rgb888 warp banks of the ceiling and
    the floor (double the target extent); in direct mode the raw depth and
    rgb banks themselves.
    """
    bank_ceil = render_identity_batched(depths, rgbs, CEILING_Z_RANGE, render_cfg)
    bank_floor = render_identity_batched(depths, rgbs, FLOOR_Z_RANGE, render_cfg)
    if not use_warp_renders:
        return depths, rgbs, bank_ceil, bank_floor
    from salve_tpu_torch.ops.warp import pack_rgb888, render_identity_bank_extended

    bank_px = 2 * render_cfg.img_px
    ext_ceil = pack_rgb888(render_identity_bank_extended(depths, rgbs, CEILING_Z_RANGE, render_cfg, bank_px))
    ext_floor = pack_rgb888(render_identity_bank_extended(depths, rgbs, FLOOR_Z_RANGE, render_cfg, bank_px))
    return ext_ceil, ext_floor, bank_ceil, bank_floor


def score_floor_hypotheses(
    model: torch.nn.Module,
    cfg: TrainingConfig,
    depths: np.ndarray,
    rgbs: np.ndarray,
    pano_id_to_bank_row: Dict[int, int],
    hypotheses: List[Tuple[int, int, object]],
    batch_size: int = 32,
    render_cfg: BEVRenderConfig = BEVRenderConfig(),
    use_warp_renders: Optional[bool] = None,
    device: DeviceLike = None,
    mesh: Optional[Mesh] = None,
) -> List[ScoredHypothesis]:
    """Score every (i1, i2, AlignmentHypothesis) of a floor.

    Args:
        model: the early-fusion verifier (ceiling+floor RGB modalities); it
            is moved to `device` and put in eval mode.
        depths: (P, 512, 1024) depth bank in mm; rgbs: (P, 512, 1024, 3) in [0, 1].
        pano_id_to_bank_row: pano ID -> bank row.
        hypotheses: (i1, i2, AlignmentHypothesis) triples.
        batch_size: hypotheses per batch (global across the mesh); the last
            batch is padded with its last hypothesis.
        use_warp_renders: render pano 1 per hypothesis as a Sim(2) warp of
            an extended identity bank instead of a fresh splat. None means
            on when the device is CUDA (the production default on the
            accelerator), off on the CPU.
        device: None means the CUDA card (raises without one); "cpu" runs
            the plain versions of the kernels. With a mesh, the mesh's device.
        mesh: this rank's place on a mesh (parallel/mesh.py:make_mesh); each
            rank scores its rows of every batch. None: one device.
    """
    dev = resolve_device(device) if mesh is None else mesh.device
    if mesh is not None and batch_size % mesh.size != 0:
        raise ValueError(f"batch_size {batch_size} not divisible by mesh size {mesh.size}")
    if set(cfg.modalities) != {"ceiling_rgb_texture", "floor_rgb_texture"}:
        raise ValueError("Fused inference supports the ceiling+floor RGB verifier.")
    if not hypotheses:
        return []
    if use_warp_renders is None:
        use_warp_renders = dev.type == "cuda"
    model = model.to(dev).eval()

    # uint16 mm -> float32 is exact; float32 banks index on every device.
    depths_d = torch.as_tensor(np.asarray(depths, dtype=np.float32), device=dev)
    rgbs_d = torch.as_tensor(np.asarray(rgbs, dtype=np.float32), device=dev)
    depths_d, rgbs_d, bank_ceil, bank_floor = build_banks(depths_d, rgbs_d, render_cfg, use_warp_renders)

    rows = {pano_id_to_bank_row[i] for h in hypotheses for i in h[:2]}
    if not all(0 <= r < depths_d.shape[0] for r in rows):
        raise ValueError(f"bank rows {sorted(rows)} outside a bank of {depths_d.shape[0]} panos")

    results: List[ScoredHypothesis] = []
    for start in range(0, len(hypotheses), batch_size):
        chunk = hypotheses[start : start + batch_size]
        chunk_p = chunk + [chunk[-1]] * (batch_size - len(chunk))
        if mesh is not None:
            chunk_p = shard_batch(mesh, chunk_p)
        i1_idx = torch.tensor([pano_id_to_bank_row[h[0]] for h in chunk_p], device=dev)
        i2_idx = torch.tensor([pano_id_to_bank_row[h[1]] for h in chunk_p], device=dev)
        rotations = torch.from_numpy(
            np.stack([h[2].i2Ti1.rotation for h in chunk_p]).astype(np.float32)
        ).to(dev)
        translations = torch.from_numpy(
            np.stack([h[2].i2Ti1.translation for h in chunk_p]).astype(np.float32)
        ).to(dev)

        y_hat, prob = score_batch(
            model, cfg, render_cfg, use_warp_renders, depths_d, rgbs_d,
            bank_ceil, bank_floor, i1_idx, i2_idx, rotations, translations,
        )
        if mesh is not None:
            y_hat, prob = all_gather_rows(mesh, y_hat), all_gather_rows(mesh, prob)
        y_hat, prob = y_hat.cpu().numpy(), prob.cpu().numpy()
        for k, (i1, i2, ah) in enumerate(chunk):
            results.append(
                ScoredHypothesis(
                    i1=i1,
                    i2=i2,
                    wdo_pair_uuid=f"{ah.wdo_alignment_object}_{ah.i1_wdo_idx}_{ah.i2_wdo_idx}",
                    configuration=ah.configuration,
                    y_hat=int(y_hat[k]),
                    prob=float(prob[k]),
                )
            )
    return results
