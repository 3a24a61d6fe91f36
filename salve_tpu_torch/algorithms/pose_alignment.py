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

The winner is chaotic where the estimated poses are near-exact (a floor
chained from oracle relative poses): every hypothesis's mean rotation error
is then a few float32 ulps of an angle, and an ulp anywhere can hand the
sequential rule another iteration, whose translation, scale and floorplan
IoU differ visibly. So the float32 arithmetic here is the reference's as
XLA:CPU compiles it, op for op, and gives the same bits on every device:
sin, cos and atan2 are glibc's (`ops/libm.py`); each sum over the poses
adds in the order XLA's compiled loop adds it at that pose count
(`ops/xla_sum.py`), and each 3-vector sum in index order; where XLA fuses a
product into the add or subtract that consumes it, the port takes one FMA
(`fma_f32_exact`); the jitted hypothesis scorer's rewrite of
(sum / count) / scale into sum / (count * scale) is kept; and sqrt is
IEEE's (`ops/numerics.py:sqrt_f32`). The single fit outside the jit
(`align_poses_sim3_ignore_missing`) runs op by op in the reference, so
there products are rounded before they are summed.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from salve_tpu_torch.device import DeviceLike, resolve_device
from salve_tpu_torch.geometry.poses import Pose3, Sim3, rotation_angle_deg
from salve_tpu_torch.ops.libm import atan2f, cosf, sinf
from salve_tpu_torch.ops.numerics import fma_f32_exact, sqrt_f32
from salve_tpu_torch.ops.xla_sum import ordered_sum, ransac_plans

DEFAULT_RANSAC_ALIGNMENT_DELETE_FRAC = 0.33
# jnp.rad2deg's float32 factor, and the degenerate-scale threshold in float32.
_RAD2DEG = float(np.float32(180.0 / np.pi))
_SCALE_EPS = float(np.float32(1e-9))


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


def _dot(a: torch.Tensor, b: torch.Tensor, fused: bool = True) -> torch.Tensor:
    """sum_j a[..., j] * b[..., j] in index order: an FMA chain (XLA's dot
    and fused reductions), or rounded products and adds (`fused=False`)."""
    a, b = torch.broadcast_tensors(a, b)
    acc = a[..., 0] * b[..., 0]
    for j in range(1, a.shape[-1]):
        acc = fma_f32_exact(a[..., j], b[..., j], acc) if fused else acc + a[..., j] * b[..., j]
    return acc


def _matvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., i, j) @ (..., j) -> (..., i), as XLA:CPU's dot."""
    return _dot(A, x[..., None, :])


def _planar_rotation(theta: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotations about +z by `theta`."""
    c, s_ = cosf(theta), sinf(theta)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack(
        [
            torch.stack([c, -s_, zero], dim=-1),
            torch.stack([s_, c, zero], dim=-1),
            torch.stack([zero, zero, one], dim=-1),
        ],
        dim=-2,
    )


def _scale(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    one = torch.ones_like(den)
    scale = torch.where(den > 0, num / torch.where(den > 0, den, one), one)
    # Degenerate single-point / collapsed hypotheses: fall back to scale 1.
    return torch.where(torch.abs(scale) < _SCALE_EPS, one, scale)


def _fit_planar_sim3(
    theta_a: torch.Tensor,
    ca: torch.Tensor,
    theta_b: torch.Tensor,
    cb: torch.Tensor,
    w: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Masked closed-form planar Sim(3) fit aSb with p_a = s (R p_b + t).

    Broadcasts over leading hypothesis dims; w is the per-camera weight/mask.
    Returns (theta, t(3,), s), rounded as the reference's op-by-op fit.
    """
    wsum = ordered_sum(w, -1)
    dtheta = theta_a - theta_b
    # Circular mean of angle differences.
    theta = atan2f(ordered_sum(w * sinf(dtheta), -1), ordered_sum(w * cosf(dtheta), -1))
    R = _planar_rotation(theta)
    ca_cent = ordered_sum(ca * w[..., None], -2) / wsum[..., None]
    cb_cent = ordered_sum(cb * w[..., None], -2) / wsum[..., None]
    da = ca - ca_cent[..., None, :]
    db = cb - cb_cent[..., None, :]
    Rdb = _matvec(R[..., None, :, :], db)
    num = ordered_sum(w * _dot(da, Rdb, fused=False), -1)
    den = ordered_sum(w * _dot(db, db, fused=False), -1)
    scale = _scale(num, den)
    t = ca_cent / scale[..., None] - _matvec(R, cb_cent)
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
    The float32 rounding is the jitted reference's on XLA:CPU (module
    docstring): its fusions turn each product that feeds a sum into an FMA,
    and t's (sum / count) / scale into sum / (count * scale).
    """
    plan = ransac_plans(theta_a.shape[0]).get
    w = keep_masks * valid[None, :]  # (H, N), 0 or 1: products with w are exact
    nkept = ordered_sum(w, -1)
    dtheta = theta_a - theta_b
    theta = atan2f(ordered_sum(w * sinf(dtheta), -1, plan("S")), ordered_sum(w * cosf(dtheta), -1, plan("C")))
    R = _planar_rotation(theta)  # (H, 3, 3)
    ca_sum = ordered_sum(ca[None, :, :] * w[..., None], -2, plan("ca"))
    cb_cent = ordered_sum(cb[None, :, :] * w[..., None], -2, plan("cb")) / nkept[:, None]
    ca_cent = ca_sum / nkept[:, None]
    db = cb[None, :, :] - cb_cent[:, None, :]
    Rdb = _matvec(R[:, None, :, :], db)
    num = ordered_sum(w * _dot(ca[None, :, :] - ca_cent[:, None, :], Rdb), -1, plan("num"))
    den = ordered_sum(w * _dot(db, db), -1, plan("den"))
    s = _scale(num, den)
    t = ca_sum / (nkept * s)[:, None] - _matvec(R, cb_cent)
    # Evaluate against the kept poses of each hypothesis.
    dtheta = dtheta[None, :] - theta[:, None]
    rot_err = torch.abs(atan2f(sinf(dtheta), cosf(dtheta)) * _RAD2DEG)
    Rcb = _matvec(R[:, None, :, :], cb[None, :, :])
    diff = fma_f32_exact(-s[:, None, None], Rcb + t[:, None, :], ca[None, :, :])
    trans_err = sqrt_f32(_dot(diff, diff))
    mean_rot = ordered_sum(rot_err * w, -1, plan("rot")) / nkept
    mean_trans = ordered_sum(trans_err * w, -1, plan("trans")) / nkept
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
