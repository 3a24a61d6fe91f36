"""Reference-API wrappers over the BEV fills and masks (port of
salve_tpu/utils/interpolation_utils.py): the same names and semantics, on
ops/bev.py's plain-torch `fill_holes`, `nearest_fill` and
`hallucination_mask`, run on `device`.
"""

from __future__ import annotations

import numpy as np
import torch

from salve_tpu_torch.device import DeviceLike, resolve_device
from salve_tpu_torch.ops import bev as bev_ops

DEFAULT_KERNEL_SZ = bev_ops.DEFAULT_MASK_KERNEL
MIN_REQUIRED_POINTS_SIMPLEX = 4


def is_collinear(points: np.ndarray) -> bool:
    """Cheap degenerate-input check: all x or all y equal."""
    if np.allclose(points[:, 0], points[0, 0]):
        return True
    if np.allclose(points[:, 1], points[0, 1]):
        return True
    return False


def interp_dense_grid_from_sparse(
    bev_img: np.ndarray,
    points: np.ndarray,
    rgb_values: np.ndarray,
    grid_h: int,
    grid_w: int,
    is_semantics: bool,
    device: DeviceLike = None,
) -> np.ndarray:
    """Populate a dense (grid_h, grid_w, 3) image from sparse samples: the
    dilation fill, or nearest propagation for semantics. Like the
    reference, returns the input grid itself for degenerate inputs."""
    if points.shape[0] < MIN_REQUIRED_POINTS_SIMPLEX:
        return bev_img
    if is_collinear(points):
        return bev_img
    dev = resolve_device(device)

    xy = np.round(points[:, :2]).astype(np.int64)
    keep = (xy[:, 0] >= 0) & (xy[:, 0] < grid_w) & (xy[:, 1] >= 0) & (xy[:, 1] < grid_h)
    xy, vals = xy[keep], np.asarray(rgb_values, dtype=np.float32)[keep]

    sparse = np.zeros((grid_h, grid_w, 3), dtype=np.float32)
    occ = np.zeros((grid_h, grid_w), dtype=bool)
    sparse[xy[:, 1], xy[:, 0]] = vals
    occ[xy[:, 1], xy[:, 0]] = True

    fill = bev_ops.nearest_fill if is_semantics else bev_ops.fill_holes
    out = fill(torch.as_tensor(sparse, device=dev), torch.as_tensor(occ, device=dev))
    return out.cpu().numpy().astype(bev_img.dtype)


def remove_hallucinated_content(
    sparse_bev_img: np.ndarray, interp_bev_img: np.ndarray, K: int = DEFAULT_KERNEL_SZ, device: DeviceLike = None
) -> np.ndarray:
    """Zero interpolated cells with no sparse support in a KxK window
    (support: all three channels nonzero)."""
    dev = resolve_device(device)
    mask = bev_ops.hallucination_mask(torch.as_tensor(sparse_bev_img.astype(np.uint8), device=dev), k=K)
    return (mask.cpu().numpy()[..., None] * interp_bev_img).astype(np.uint8)
