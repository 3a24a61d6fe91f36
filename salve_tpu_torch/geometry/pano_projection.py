"""Equirectangular ray grid (port of salve_tpu/geometry/pano_projection.py)."""

from __future__ import annotations

import math

import torch

from salve_tpu_torch.ops.numerics import div_const


def get_uni_sphere_xyz(H: int, W: int, device=None) -> torch.Tensor:
    """(H, W, 3) float32 unit-sphere ray grid in the HoHoNet convention.

    Same formula as salve_tpu/geometry/pano_projection.py:157: u spans the
    width with a half-pixel offset, v the height; x right, y down-ish, z up.
    The divisions round as they do inside the JAX package's jitted
    backprojection (ops/numerics.py).
    """
    jj, ii = torch.meshgrid(
        torch.arange(H, device=device) * 1.0,
        torch.arange(W, device=device) * 1.0,
        indexing="ij",
    )
    u = div_const(-(ii + 0.5), W) * 2 * math.pi
    v = (div_const(jj + 0.5, H) - 0.5) * math.pi
    z = -torch.sin(v)
    c = torch.cos(v)
    y = c * torch.sin(u)
    x = c * torch.cos(u)
    return torch.stack([x, y, z], dim=-1)
