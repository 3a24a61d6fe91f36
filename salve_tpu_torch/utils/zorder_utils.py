"""Reference-API wrapper over the z-order splat (port of
salve_tpu/utils/zorder_utils.py).

`choose_elevated_repeated_vals` keeps the reference's semantics (4 z-slices
over [-2, 2), bottom-to-top overwrite, the later index wins within a slice):
the splat runs on `device` through `ops/splat.py:splat_zorder_batched`
(kernel B1 on the card), and the winners are read back on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from salve_tpu_torch.device import DeviceLike, resolve_device
from salve_tpu_torch.ops import bev as bev_ops
from salve_tpu_torch.ops.splat import NUM_Z_SLICES, ZMAX, ZMIN


def choose_elevated_repeated_vals(
    x: np.ndarray,
    y: np.ndarray,
    z: np.ndarray,
    zmin: float = -2,
    zmax: float = 2,
    num_slices: int = 4,
    device: DeviceLike = None,
) -> np.ndarray:
    """(N,) bool mask of points winning their (x, y) cell by elevation.

    Like the reference, x and y are non-negative grid indices; the grid
    extent is (max + 1) in each dimension. `device=None` is the card.
    """
    if (zmin, zmax, num_slices) != (ZMIN, ZMAX, NUM_Z_SLICES):
        raise NotImplementedError("Non-default z binning is not wired through the device kernel.")
    dev = resolve_device(device)
    n = x.shape[0]
    img_w = int(x.max()) + 1
    img_h = int(y.max()) + 1

    xy = np.stack([x, y], axis=1).astype(np.int32)
    z_bin = np.floor((z - zmin) / (zmax - zmin) * num_slices).astype(np.int64)
    in_zrange = (z >= zmin) & (z < zmax)
    bev_ops.splat_zorder(
        torch.as_tensor(xy, device=dev),
        torch.as_tensor(z.astype(np.float32), device=dev),
        torch.zeros((n, 3), dtype=torch.float32, device=dev),
        torch.as_tensor(in_zrange, device=dev),
        img_h,
        img_w,
    )
    # The splat keeps each cell's winner; as in the reference, the winners'
    # indices come from the same priority key on the host, from the float64
    # heights, so a height on a bin edge bins as the reference bins it.
    key = np.where(in_zrange, z_bin * n + np.arange(n), -1)
    cell = y.astype(np.int64) * img_w + x.astype(np.int64)
    grid = np.full(img_h * img_w, -1, dtype=np.int64)
    np.maximum.at(grid, cell[key >= 0], key[key >= 0])
    valid = np.zeros(n, dtype=bool)
    valid[grid[grid >= 0] % n] = True
    return valid
