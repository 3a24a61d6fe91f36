"""Point-cloud registration (ICP) in PyTorch: port of salve_tpu/baselines/icp.py.

Colored multi-scale ICP and point-to-point ICP, the roles of Open3D's
pipelines in the original SALVe baseline:

  * correspondences: brute-force nearest neighbour through one (N, M)
    distance matrix a iteration, |a|^2 - 2 a.b + |b|^2, one float32 matrix
    product (clouds are voxel-downsampled and capped at MAX_POINTS first);
  * transform update: the closed-form Umeyama SE(3) fit, with the
    determinant correction that makes R a proper rotation whatever signs
    the SVD picks;
  * fixed iteration counts a scale, no early stop.

The iteration loops run in torch on `device` (None: the card, where
`resolve_device` turns TF32 off, so the distance product is full float32).
Voxel downsampling and subsampling stay host numpy, as in the original
(`default_rng(0)`). The card's argmin near-ties and SVD signs differ from
XLA's, so the transform is held to a tolerance, not bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from salve_tpu_torch.device import DeviceLike, resolve_device

VOXEL_RADII = (0.04, 0.02, 0.01)  # multi-scale schedule
MAX_ITERS = (50, 30, 14)
MAX_POINTS = 4096
COLOR_WEIGHT = 0.1


def voxel_downsample(points: np.ndarray, voxel: float, colors: Optional[np.ndarray] = None):
    """Average points (and colours) within each voxel (host-side)."""
    keys = np.floor(points / voxel).astype(np.int64)
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    inv = inv.reshape(-1)
    n_vox = counts.shape[0]
    out = np.zeros((n_vox, 3))
    np.add.at(out, inv, points)
    out /= counts[:, None]
    if colors is not None:
        cout = np.zeros((n_vox, colors.shape[1]))
        np.add.at(cout, inv, colors)
        cout /= counts[:, None]
        return out, cout
    return out


def _subsample(points: np.ndarray, colors: Optional[np.ndarray], max_points: int):
    if points.shape[0] <= max_points:
        return points, colors
    idx = np.random.default_rng(0).choice(points.shape[0], max_points, replace=False)
    return points[idx], (colors[idx] if colors is not None else None)


def _sq_dists(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(N, M) squared distances, |q|^2 - 2 q.t + |t|^2 in the original's order."""
    return (q**2).sum(1)[:, None] - 2 * q @ t.T + (t**2).sum(1)[None]


def _umeyama(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted rigid fit b ~ R a + t; det(R) = +1 by the sign correction."""
    wsum = torch.clamp(w.sum(), min=1e-9)
    ca = (a * w[:, None]).sum(0) / wsum
    cb = (b * w[:, None]).sum(0) / wsum
    H = ((a - ca) * w[:, None]).T @ (b - cb)
    U, _, Vt = torch.linalg.svd(H)
    d = torch.sign(torch.linalg.det(Vt.T @ U.T))
    D = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    R = Vt.T @ D @ U.T
    return R, cb - R @ ca


def _icp_point_to_point(src, tgt, R, t, max_dist: float, iters: int):
    """Fixed-iteration point-to-point ICP; returns (R, t)."""
    rows = torch.arange(src.shape[0], device=src.device)
    for _ in range(iters):
        src_t = src @ R.T + t
        d2 = _sq_dists(src_t, tgt)
        j = torch.argmin(d2, dim=1)
        valid = torch.sqrt(torch.clamp(d2[rows, j], min=0.0)) <= max_dist
        R_new, t_new = _umeyama(src_t, tgt[j], valid.to(src.dtype))
        R, t = R_new @ R, R_new @ t + t_new
    return R, t


def _icp_colored_scale(src, tgt, src6, tgt6, R, t, max_dist: float, iters: int):
    """One scale of colored ICP: 6D (xyz + weighted rgb) matching, an xyz
    rigid fit over the matches within `max_dist`; returns (R, t)."""
    for _ in range(iters):
        src_t = src @ R.T + t
        q = torch.cat([src_t, src6[:, 3:]], dim=1)
        j = torch.argmin(_sq_dists(q, tgt6), dim=1)
        w = (torch.linalg.norm(src_t - tgt[j], dim=1) <= max_dist).to(src.dtype)
        R_new, t_new = _umeyama(src_t, tgt[j], w)
        R, t = R_new @ R, R_new @ t + t_new
    return R, t


def _to_4x4(R: torch.Tensor, t: torch.Tensor) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = R.cpu().numpy()
    T[:3, 3] = t.cpu().numpy()
    return T


def register_point_clouds(
    source: np.ndarray, target: np.ndarray, max_correspondence_distance: float = 0.02, device: DeviceLike = None
) -> np.ndarray:
    """Register source (N, 3) to target (M, 3) with point-to-point ICP
    (30 iterations); returns tTs as a 4x4 matrix."""
    dev = resolve_device(device)
    src = voxel_downsample(source, max_correspondence_distance / 2)
    tgt = voxel_downsample(target, max_correspondence_distance / 2)
    src, _ = _subsample(src, None, MAX_POINTS)
    tgt, _ = _subsample(tgt, None, MAX_POINTS)

    f32 = dict(dtype=torch.float32, device=dev)
    R, t = _icp_point_to_point(torch.as_tensor(src, **f32), torch.as_tensor(tgt, **f32), torch.eye(3, **f32),
                               torch.zeros(3, **f32), float(np.float32(max_correspondence_distance)), 30)
    return _to_4x4(R, t)


def colored_scale_inputs(source_xyzrgb: np.ndarray, target_xyzrgb: np.ndarray, radius: float, dev: torch.device):
    """(src, tgt, src6, tgt6) float32 tensors on `dev` for one scale: both
    clouds voxel-downsampled at `radius`, capped at MAX_POINTS, and the 6D
    matching vectors (xyz + COLOR_WEIGHT * rgb)."""
    src, src_c = voxel_downsample(source_xyzrgb[:, :3], radius, source_xyzrgb[:, 3:6])
    tgt, tgt_c = voxel_downsample(target_xyzrgb[:, :3], radius, target_xyzrgb[:, 3:6])
    src, src_c = _subsample(src, src_c, MAX_POINTS)
    tgt, tgt_c = _subsample(tgt, tgt_c, MAX_POINTS)
    src6 = np.hstack([src, src_c * COLOR_WEIGHT])
    tgt6 = np.hstack([tgt, tgt_c * COLOR_WEIGHT])
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (src, tgt, src6, tgt6))


def register_colored_point_clouds(
    source_xyzrgb: np.ndarray, target_xyzrgb: np.ndarray, device: DeviceLike = None
) -> np.ndarray:
    """Multi-scale registration of (N, 6) xyzrgb clouds; returns tTs (4x4).

    The coarse-to-fine voxel schedule of Open3D's colored ICP; the colour
    term enters through the 6D nearest-neighbour matching. The pose is
    carried between scales in float64 on the host, as the original does.
    """
    dev = resolve_device(device)
    R = np.eye(3)
    t = np.zeros(3)
    for radius, iters in zip(VOXEL_RADII, MAX_ITERS):
        src, tgt, src6, tgt6 = colored_scale_inputs(source_xyzrgb, target_xyzrgb, radius, dev)
        R_j, t_j = _icp_colored_scale(
            src, tgt, src6, tgt6, torch.as_tensor(R, dtype=torch.float32, device=dev),
            torch.as_tensor(t, dtype=torch.float32, device=dev), float(np.float32(radius)), iters)
        R, t = R_j.cpu().numpy().astype(np.float64), t_j.cpu().numpy().astype(np.float64)

    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T
