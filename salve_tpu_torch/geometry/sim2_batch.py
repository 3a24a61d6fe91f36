"""Batched Sim(2) operations on tensors (port of salve_tpu/geometry/sim2_batch.py).

A batch of Sim(2) elements is a tuple of stacked tensors ``(R, t, s)`` with
shapes ``(..., 2, 2)``, ``(..., 2)``, ``(...,)``. All functions broadcast
over leading batch dimensions and run on whatever device their inputs are on.

Conventions match `salve_tpu_torch.geometry.sim2.Sim2`: point action
p_out = s * (R p + t).

The reference runs its 2x2 products at `Precision.HIGHEST` (plain float32).
Here they are elementwise products and sums (`matvec`, `matmul`), never a
matmul call, so no TF32 setting can reach them on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

Sim2Params = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def matvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., i, j) @ (..., j) -> (..., i), in float32 elementwise ops."""
    return (A * x[..., None, :]).sum(-1)


def matmul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(..., i, k) @ (..., k, j) -> (..., i, j), in float32 elementwise ops."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def identity(batch_shape: Tuple[int, ...] = (), device=None) -> Sim2Params:
    """Identity Sim(2) broadcast to a batch shape."""
    R = torch.eye(2, device=device).expand(batch_shape + (2, 2))
    t = torch.zeros(batch_shape + (2,), device=device)
    s = torch.ones(batch_shape, device=device)
    return R, t, s


def compose(a: Sim2Params, b: Sim2Params) -> Sim2Params:
    """Group composition a∘b (matches 3x3 matrix product of the block forms)."""
    Ra, ta, sa = a
    Rb, tb, sb = b
    R = matmul(Ra, Rb)
    t = matvec(Ra, tb) + ta / sb[..., None]
    s = sa * sb
    return R, t, s


def inverse(a: Sim2Params) -> Sim2Params:
    Ra, ta, sa = a
    Rt = Ra.transpose(-1, -2)
    t = -matvec(Rt, sa[..., None] * ta)
    return Rt, t, 1.0 / sa


def transform(a: Sim2Params, pts: torch.Tensor) -> torch.Tensor:
    """Apply Sim(2) batch to points (..., N, 2): p_out = s*(R p + t)."""
    Ra, ta, sa = a
    out = matvec(Ra[..., None, :, :], pts) + ta[..., None, :]
    return out * sa[..., None, None]


def theta_deg(a: Sim2Params) -> torch.Tensor:
    """Rotation angle in degrees from the (cos, sin) in R's first column."""
    Ra = a[0]
    return torch.rad2deg(torch.atan2(Ra[..., 1, 0], Ra[..., 0, 0]))


def from_theta(theta_rad: torch.Tensor, t: torch.Tensor, s: torch.Tensor) -> Sim2Params:
    c, sn = torch.cos(theta_rad), torch.sin(theta_rad)
    R = torch.stack([torch.stack([c, -sn], dim=-1), torch.stack([sn, c], dim=-1)], dim=-2)
    return R, t, s


def wrap_angle_deg(angle1: torch.Tensor, angle2: torch.Tensor) -> torch.Tensor:
    """Minimum angular difference (degrees), elementwise.

    `torch.remainder` is the floor-mod of the reference's `%`; `torch.fmod`
    (truncating) would differ on negative differences.
    """
    diff = torch.remainder(angle2 - angle1 + 180.0, 360.0) - 180.0
    diff = torch.where(diff < -180.0, diff + 360.0, diff)
    return torch.abs(diff)


def almost_equal(
    a: Sim2Params,
    b: Sim2Params,
    trans_atol: torch.Tensor,
    scale_atol: torch.Tensor,
    angle_atol_deg: torch.Tensor,
) -> torch.Tensor:
    """Elementwise tolerance-equality of two Sim(2) batches.

    Mirrors the reference's obj_almost_equal (salve/utils/wdo_alignment.py:418):
    translation via per-component atol, scale via atol, angle via wrapped diff.
    """
    _, ta, sa = a
    _, tb, sb = b
    trans_ok = torch.all(torch.abs(ta - tb) <= trans_atol, dim=-1)
    scale_ok = torch.abs(sa - sb) <= scale_atol
    angle_ok = wrap_angle_deg(theta_deg(a), theta_deg(b)) <= angle_atol_deg
    return trans_ok & scale_ok & angle_ok
