"""Sim(3) pose-graph alignment for evaluation, with batched RANSAC on the card.

Port of salve_tpu/algorithms/pose_alignment.py. Replaces the reference's
GTSFM/GTSAM stack (salve/utils/ransac.py:14, which loops 1000 sequential C++
alignments) with one batched solve over all RANSAC hypotheses: each
hypothesis is a row of a (num_iters, N) keep-mask and the closed-form planar
Sim(3) fit is a handful of masked reductions.

The pipeline's pose graphs are planar (rotations about +z, z=0 translation),
so the Sim(3) fit decomposes exactly into:
  theta* = circular mean of per-camera angle differences,
  s*, t* = least-squares scale/translation of camera centers given theta*.
This mirrors GTSAM Similarity3::Align(posePairs) (rotation averaging followed
by center alignment), specialized to the planar case.

The fits run in float32, as the reference's do (it hands float64 numpy to
JAX with 64-bit mode off). The keep-masks come from the same
`np.random.default_rng(seed)` draws, so both see the same hypotheses; the
winner is picked on the host by the reference's sequential rule.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from salve_tpu_torch.device import DeviceLike, resolve_device
from salve_tpu_torch.geometry.poses import Pose3, Sim3, rotation_angle_deg
from salve_tpu_torch.geometry.sim2_batch import matvec

DEFAULT_RANSAC_ALIGNMENT_DELETE_FRAC = 0.33


def _planar_params(poses: List[Optional[Pose3]]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Extract (theta, center, valid) stacked arrays from an Optional[Pose3] list."""
    n = len(poses)
    thetas = np.zeros(n)
    centers = np.zeros((n, 3))
    valid = np.zeros(n, dtype=bool)
    for i, p in enumerate(poses):
        if p is None:
            continue
        thetas[i] = math.atan2(p.R[1, 0], p.R[0, 0])
        centers[i] = p.t
        valid[i] = True
    return thetas, centers, valid


def _f32(x: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)


def _planar_rotation(theta: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotations about +z by `theta`."""
    c, s_ = torch.cos(theta), torch.sin(theta)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack(
        [
            torch.stack([c, -s_, zero], dim=-1),
            torch.stack([s_, c, zero], dim=-1),
            torch.stack([zero, zero, one], dim=-1),
        ],
        dim=-2,
    )


def _fit_planar_sim3(
    theta_a: torch.Tensor,
    ca: torch.Tensor,
    theta_b: torch.Tensor,
    cb: torch.Tensor,
    w: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Masked closed-form planar Sim(3) fit aSb with p_a = s (R p_b + t).

    Broadcasts over leading hypothesis dims; w is the per-camera weight/mask.
    Returns (theta, t(3,), s).
    """
    wsum = torch.sum(w, dim=-1)
    dtheta = theta_a - theta_b
    # Circular mean of angle differences.
    theta = torch.atan2(torch.sum(w * torch.sin(dtheta), dim=-1), torch.sum(w * torch.cos(dtheta), dim=-1))
    R = _planar_rotation(theta)
    ca_cent = torch.sum(ca * w[..., None], dim=-2) / wsum[..., None]
    cb_cent = torch.sum(cb * w[..., None], dim=-2) / wsum[..., None]
    da = ca - ca_cent[..., None, :]
    db = cb - cb_cent[..., None, :]
    Rdb = matvec(R[..., None, :, :], db)
    num = torch.sum(w * torch.sum(da * Rdb, dim=-1), dim=-1)
    den = torch.sum(w * torch.sum(db * db, dim=-1), dim=-1)
    scale = torch.where(den > 0, num / torch.where(den > 0, den, torch.ones_like(den)), torch.ones_like(den))
    # Degenerate single-point / collapsed hypotheses: fall back to scale 1.
    scale = torch.where(torch.abs(scale) < 1e-9, torch.ones_like(scale), scale)
    t = ca_cent / scale[..., None] - matvec(R, cb_cent)
    return theta, t, scale


def _ransac_errors(
    theta_a: torch.Tensor,
    ca: torch.Tensor,
    theta_b: torch.Tensor,
    cb: torch.Tensor,
    valid: torch.Tensor,
    keep_masks: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fit one Sim(3) per keep-mask row, score each over its KEPT subset.

    Parity: salve/utils/ransac.py:53-67 — the reference aligns the subset
    and evaluates compute_pose_errors_3d on that aligned subset (deleted
    poses are None there), so hypothesis errors exclude the deleted poses.
    Scoring over ALL poses would make a degenerate tiny-scale fit (which
    shrinks every residual) beat an outlier-free fit.

    Returns per-hypothesis (mean_rot_err_deg, mean_trans_err, theta, t, s).
    """
    w = keep_masks * valid[None, :]
    theta, t, s = _fit_planar_sim3(theta_a[None, :], ca[None, :, :], theta_b[None, :], cb[None, :, :], w)
    # Evaluate against the kept poses of each hypothesis.
    dtheta = theta_a[None, :] - theta_b[None, :] - theta[:, None]
    rot_err = torch.abs(torch.rad2deg(torch.atan2(torch.sin(dtheta), torch.cos(dtheta))))
    R = _planar_rotation(theta)
    cb_in_a = s[:, None, None] * (matvec(R[:, None, :, :], cb[None, :, :]) + t[:, None, :])
    trans_err = torch.linalg.norm(ca[None, :, :] - cb_in_a, dim=-1)
    nkept = torch.sum(w, dim=-1)
    mean_rot = torch.sum(rot_err * w, dim=-1) / nkept
    mean_trans = torch.sum(trans_err * w, dim=-1) / nkept
    return mean_rot, mean_trans, theta, t, s


def align_poses_sim3_ignore_missing(
    aTi_list: List[Optional[Pose3]], bTi_list: List[Optional[Pose3]], device: DeviceLike = None
) -> Tuple[List[Optional[Pose3]], Sim3]:
    """Single (non-robust) Sim(3) alignment of pose graph b onto a, skipping
    missing poses, on `device` (None: the CUDA card; raises without one)."""
    dev = resolve_device(device)
    n = min(len(aTi_list), len(bTi_list))
    theta_a, ca, va = _planar_params(aTi_list[:n])
    theta_b, cb, vb = _planar_params(bTi_list[:n])
    valid = va & vb
    if valid.sum() == 0:
        return list(bTi_list), Sim3.identity()
    theta, t, s = (
        x.cpu().numpy()
        for x in _fit_planar_sim3(
            _f32(theta_a, dev), _f32(ca, dev), _f32(theta_b, dev), _f32(cb, dev), _f32(valid, dev)
        )
    )
    aSb = _sim3_from_planar(float(theta), t, float(s))
    aligned = [aSb.transform_pose(bTi) if bTi is not None else None for bTi in bTi_list]
    return aligned, aSb


def _sim3_from_planar(theta: float, t: np.ndarray, s: float) -> Sim3:
    c, s_ = np.cos(theta), np.sin(theta)
    R = np.array([[c, -s_, 0.0], [s_, c, 0.0], [0.0, 0.0, 1.0]])
    return Sim3(R, np.asarray(t, dtype=np.float64), float(s))


def ransac_keep_masks(valid: np.ndarray, num_iters: int, delete_frac: float, seed: int) -> Optional[np.ndarray]:
    """(num_iters, N) float32 keep-masks, each deleting `delete_frac` of the
    valid poses, drawn exactly as the reference draws them; None when fewer
    than 2 poses would be kept."""
    valid_idxs = np.flatnonzero(valid)
    num_to_delete = math.ceil(delete_frac * len(valid_idxs))
    if len(valid_idxs) - num_to_delete < 2:
        return None
    rng = np.random.default_rng(seed)
    keep = np.ones((num_iters, len(valid)), dtype=np.float32)
    for it in range(num_iters):
        delete_idxs = rng.choice(valid_idxs, size=num_to_delete, replace=False)
        keep[it, delete_idxs] = 0.0
    return keep


def ransac_winner(mean_rot: np.ndarray, mean_trans: np.ndarray) -> int:
    """The reference's sequential acceptance rule: a hypothesis is adopted
    when it is no worse than the best so far in BOTH errors."""
    best = None
    best_rot, best_trans = float("inf"), float("inf")
    for it in range(len(mean_rot)):
        if mean_trans[it] <= best_trans and mean_rot[it] <= best_rot:
            best, best_rot, best_trans = it, float(mean_rot[it]), float(mean_trans[it])
    if best is None:
        raise ValueError("no RANSAC hypothesis has finite errors")
    return best


def ransac_align_poses_sim3_ignore_missing(
    aTi_list_ref: List[Optional[Pose3]],
    bTi_list_est: List[Optional[Pose3]],
    num_iters: int = 1000,
    delete_frac: float = DEFAULT_RANSAC_ALIGNMENT_DELETE_FRAC,
    seed: int = 0,
    verbose: bool = False,
    device: DeviceLike = None,
) -> Tuple[List[Optional[Pose3]], Sim3]:
    """Robust Sim(3) pose-graph alignment (parity: salve/utils/ransac.py:14).

    Each RANSAC hypothesis deletes `delete_frac` of the valid poses, fits a
    Sim(3), and is scored by mean rot/trans error over its kept poses. All
    `num_iters` hypotheses are fit and scored in one batched call on
    `device` (None: the CUDA card; raises without one).
    """
    dev = resolve_device(device)
    n = min(len(aTi_list_ref), len(bTi_list_est))
    theta_a, ca, va = _planar_params(aTi_list_ref[:n])
    theta_b, cb, vb = _planar_params(bTi_list_est[:n])
    valid = va & vb

    keep = ransac_keep_masks(valid, num_iters, delete_frac, seed)
    if keep is None:
        return align_poses_sim3_ignore_missing(aTi_list_ref, bTi_list_est, device=dev)

    mean_rot, mean_trans, theta, t, s = (
        x.cpu().numpy()
        for x in _ransac_errors(
            _f32(theta_a, dev), _f32(ca, dev), _f32(theta_b, dev), _f32(cb, dev), _f32(valid, dev),
            _f32(keep, dev),
        )
    )
    best = ransac_winner(mean_rot, mean_trans)
    if verbose:
        print(f"winner {best}: rot {mean_rot[best]:.2f} deg, trans {mean_trans[best]:.2f}")

    aSb = _sim3_from_planar(float(theta[best]), t[best], float(s[best]))
    aligned = [aSb.transform_pose(bTi) if bTi is not None else None for bTi in bTi_list_est]
    return aligned, aSb


def compute_pose_errors_3d(
    aTi_list_gt: List[Optional[Pose3]],
    aligned_bTi_list_est: List[Optional[Pose3]],
    verbose: bool = False,
) -> Tuple[float, float, np.ndarray, np.ndarray]:
    """Mean/per-camera rotation (deg) + translation errors between aligned pose graphs."""
    rot_errors, trans_errors = [], []
    for aTi, aTi_ in zip(aTi_list_gt, aligned_bTi_list_est):
        if aTi is None or aTi_ is None:
            continue
        rot_errors.append(rotation_angle_deg(aTi.R, aTi_.R))
        trans_errors.append(float(np.linalg.norm(aTi.t - aTi_.t)))
    rot_errors = np.array(rot_errors)
    trans_errors = np.array(trans_errors)
    if verbose:
        print("Rotation Errors:", np.round(rot_errors, 1))
        print("Translation Errors:", np.round(trans_errors, 1))
    return float(np.mean(rot_errors)), float(np.mean(trans_errors)), rot_errors, trans_errors
