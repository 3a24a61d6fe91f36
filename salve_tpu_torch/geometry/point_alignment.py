"""Closed-form point-set registration: SE(2) and Sim(3) fits, batched on tensors.

Port of salve_tpu/geometry/point_alignment.py. These replace the reference's
GTSAM C++ calls:
  - salve/utils/se2_estimation.py:36  (gtsam.Pose2.Align)
  - salve/utils/sim3_estimation.py:31 (gtsam.Similarity3.Align)

Both solvers are closed-form least squares over corresponding point pairs: a
handful of reductions and a 3x3 SVD, broadcast over any leading batch dims,
so one call fits every candidate W/D/O pairing of a floor on the card.

Math:
  SE(2):  theta = atan2(Σ cross(db, da), Σ dot(db, da)) over centered pairs,
          t = ca - R cb.  (Same normal equations GTSAM's Pose2::Align solves.)
  Sim(3): R = argmax tr(R Σ db da^T) via SVD projection onto SO(3),
          s = Σ da·(R db) / Σ ||db||²,  t = ca/s - R cb
          (convention p_a = s (R p_b + t), matching Similarity3::Align).

Small products are elementwise float32 ops (`sim2_batch.matvec`/`matmul`),
never a TF32 matmul. Compare R, t and s with the reference, not U and V:
torch's and JAX's SVDs may flip a singular pair's signs, which leaves
R = U·D·Vᵀ unchanged.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from salve_tpu_torch.geometry.rotations import rotmat2d, rotmat2theta_deg
from salve_tpu_torch.geometry.sim2 import Sim2
from salve_tpu_torch.geometry.sim2_batch import matmul, matvec


def fit_se2(
    pts_a: torch.Tensor, pts_b: torch.Tensor, weights: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Least-squares SE(2) fit aTb such that pts_a ≈ R @ pts_b + t.

    Args:
        pts_a: (..., N, 2) target points.
        pts_b: (..., N, 2) source points.
        weights: optional (..., N) per-pair weights (also serve as masks).

    Returns:
        R: (..., 2, 2) rotation, t: (..., 2) translation.
    """
    if weights is None:
        weights = torch.ones(pts_a.shape[:-1], dtype=pts_a.dtype, device=pts_a.device)
    w = weights[..., None]
    wsum = torch.sum(weights, dim=-1, keepdim=True)
    ca = torch.sum(pts_a * w, dim=-2) / wsum
    cb = torch.sum(pts_b * w, dim=-2) / wsum
    da = pts_a - ca[..., None, :]
    db = pts_b - cb[..., None, :]
    cos_term = torch.sum(weights * torch.sum(db * da, dim=-1), dim=-1)
    sin_term = torch.sum(weights * (db[..., 0] * da[..., 1] - db[..., 1] * da[..., 0]), dim=-1)
    theta = torch.atan2(sin_term, cos_term)
    c, s = torch.cos(theta), torch.sin(theta)
    R = torch.stack([torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2)
    t = ca - matvec(R, cb)
    return R, t


def fit_sim3(
    pts_a: torch.Tensor, pts_b: torch.Tensor, weights: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Least-squares Sim(3) fit aSb with convention pts_a ≈ s * (R @ pts_b + t).

    Args:
        pts_a: (..., N, 3) target points.
        pts_b: (..., N, 3) source points.
        weights: optional (..., N) weights/masks.

    Returns:
        R: (..., 3, 3), t: (..., 3), s: (...,) scale.
    """
    if weights is None:
        weights = torch.ones(pts_a.shape[:-1], dtype=pts_a.dtype, device=pts_a.device)
    w = weights[..., None]
    wsum = torch.sum(weights, dim=-1, keepdim=True)
    ca = torch.sum(pts_a * w, dim=-2) / wsum
    cb = torch.sum(pts_b * w, dim=-2) / wsum
    da = (pts_a - ca[..., None, :]) * w
    db = pts_b - cb[..., None, :]
    # Cross-covariance M = Σ w da db^T; R = proj_SO(3)(M).
    M = torch.sum(da[..., :, :, None] * db[..., :, None, :], dim=-3)
    U, _, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(matmul(U, Vt))
    D = torch.zeros_like(M)
    D[..., 0, 0] = 1.0
    D[..., 1, 1] = 1.0
    D[..., 2, 2] = det
    R = matmul(matmul(U, D), Vt)
    Rdb = matvec(R[..., None, :, :], db)
    num = torch.sum(weights * torch.sum((pts_a - ca[..., None, :]) * Rdb, dim=-1), dim=-1)
    den = torch.sum(weights * torch.sum(db * db, dim=-1), dim=-1)
    s = num / den
    t = ca / s[..., None] - matvec(R, cb)
    return R, t, s


# -- host-side wrappers (reference-API parity) --------------------------------

def align_points_SE2(
    pts_a: np.ndarray, pts_b: np.ndarray
) -> Tuple[Optional[Sim2], Optional[np.ndarray]]:
    """Fit SE(2) aTb between (N,2) correspondences; returns (Sim2 with s=1, aligned b).

    Parity: salve/utils/se2_estimation.py:11.
    """
    pts_a = np.asarray(pts_a, dtype=np.float64)
    pts_b = np.asarray(pts_b, dtype=np.float64)
    n = pts_a.shape[0]
    if n != pts_b.shape[0]:
        raise RuntimeError("Point clouds must have matching length.")
    if n < 2:
        return None, None
    if pts_a.shape[1] != 2 or pts_b.shape[1] != 2:
        raise RuntimeError(f"Input point clouds were of shape {pts_a.shape}, but should have been (N,2)")
    R, t = _fit_se2_np(pts_a, pts_b)
    aSb = Sim2(R=R, t=t, s=1.0)
    return aSb, pts_b @ R.T + t


def _fit_se2_np(pts_a: np.ndarray, pts_b: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """NumPy twin of fit_se2 for cheap host-side calls (no dispatch overhead)."""
    ca, cb = pts_a.mean(axis=0), pts_b.mean(axis=0)
    da, db = pts_a - ca, pts_b - cb
    cos_term = float(np.sum(db * da))
    sin_term = float(np.sum(db[:, 0] * da[:, 1] - db[:, 1] * da[:, 0]))
    theta = np.arctan2(sin_term, cos_term)
    c, s = np.cos(theta), np.sin(theta)
    R = np.array([[c, -s], [s, c]])
    return R, ca - R @ cb


def align_points_sim3(
    pts_a: np.ndarray, pts_b: np.ndarray
) -> Tuple[Optional[Sim2], np.ndarray]:
    """Fit Sim(3) between (N,3) correspondences, project to Sim(2).

    Parity: salve/utils/sim3_estimation.py:12 (including the projection of the
    3D rotation's upper-left 2x2 block and re-orthonormalization fallback).
    The fit runs in float32 on the CPU: the reference passes float64 numpy to
    JAX with 64-bit mode off, so JAX computes it in float32.
    """
    pts_a = np.asarray(pts_a, dtype=np.float64)
    pts_b = np.asarray(pts_b, dtype=np.float64)
    if pts_a.shape != pts_b.shape:
        return None, np.zeros_like(pts_a)
    if pts_a.shape[1] != 3:
        raise RuntimeError(f"Input point clouds were of shape {pts_a.shape}, but should have been (N,3)")
    R, t, s = (
        x.numpy()
        for x in fit_sim3(
            torch.as_tensor(pts_a, dtype=torch.float32), torch.as_tensor(pts_b, dtype=torch.float32)
        )
    )
    s = float(s)
    pts_a_ = s * (pts_b @ R.T + t)
    aSb = Sim2(R=R[:2, :2], t=t[:2], s=s)
    # The 2x2 block of a 3D rotation need not be a rotation; snap back to SO(2).
    if not np.allclose(aSb.rotation.T @ aSb.rotation, np.eye(2), atol=0.05):
        aSb = reorthonormalize_sim2(aSb)
    return aSb, pts_a_


def reorthonormalize_sim2(i2Ti1: Sim2) -> Sim2:
    """Snap a Sim(2)'s rotation back onto the SO(2) manifold via atan2 of its first column."""
    R = i2Ti1.rotation
    theta_deg = np.rad2deg(np.arctan2(R[1, 0], R[0, 0]))
    return Sim2(rotmat2d(theta_deg), i2Ti1.translation, i2Ti1.scale)


__all__ = [
    "fit_se2",
    "fit_sim3",
    "align_points_SE2",
    "align_points_sim3",
    "reorthonormalize_sim2",
    "rotmat2theta_deg",
]
