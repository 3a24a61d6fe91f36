"""Z-order splat: (B, N) points -> (B, H, W) grids (kernel B1).

Port of salve_tpu/ops/bev.py:splat_zorder_batched, with its per-cell max of
the priority key (salve_tpu/ops/pallas_splat.py:splat_priority_grid_pallas,
the XLA scatter-max at bev.py:165-171) as the CUDA kernel `csrc/splat.cu`.
The kernel writes the grid's -1 and the points' atomics in one cooperative
launch, with a grid-wide barrier between them.

Priority within a cell is (z_bin, point_index) lexicographic: the key
`z_bin * N + i` keeps the reference's slice-by-slice overwrite order
(salve/utils/zorder_utils.py:10). The JAX package's `_drop_dominated`
prepass does not change the output and is not ported.
"""

from __future__ import annotations

from typing import Tuple

import torch

from salve_tpu_torch import device as device_mod
from salve_tpu_torch.ops import kernels
from salve_tpu_torch.ops.numerics import div_const

# z-order binning (salve_tpu/ops/bev.py:43).
ZMIN, ZMAX, NUM_Z_SLICES = -2.0, 2.0, 4


def splat_priority_grid_plain(
    cell: torch.Tensor, key: torch.Tensor, ok: torch.Tensor, img_h: int, img_w: int
) -> torch.Tensor:
    """Plain version of B1: scatter-max into a grid with a sentinel cell."""
    b, _ = cell.shape
    hw = img_h * img_w
    grid = torch.full((b, hw + 1), -1, dtype=torch.int32, device=cell.device)
    idx = torch.where(ok, cell.long(), torch.full_like(cell, hw, dtype=torch.long))
    src = torch.where(ok, key, torch.full_like(key, -1))
    grid.scatter_reduce_(1, idx, src, reduce="amax", include_self=True)
    return grid[:, :hw].contiguous()


def splat_priority_grid_cuda(
    cell: torch.Tensor, key: torch.Tensor, ok: torch.Tensor, img_h: int, img_w: int
) -> torch.Tensor:
    """Launch B1 on the card; raises on anything but contiguous CUDA input."""
    device_mod.require_cuda_tensor("cell", cell, torch.int32)
    device_mod.require_cuda_tensor("key", key, torch.int32)
    device_mod.require_cuda_tensor("ok", ok, torch.bool)
    if cell.dim() != 2 or key.shape != cell.shape or ok.shape != cell.shape:
        raise ValueError(f"cell/key/ok must share one (B, N) shape: {cell.shape}, {key.shape}, {ok.shape}")
    b, n = cell.shape
    hw = img_h * img_w
    grid = torch.empty((b, hw), dtype=torch.int32, device=cell.device)  # B1 writes every cell
    lib = kernels.load().lib
    err = lib.salve_splat_max(
        cell.data_ptr(), key.data_ptr(), ok.data_ptr(), grid.data_ptr(),
        b, n, hw, kernels.stream_handle(cell.device),
    )
    kernels.check(err, "splat")
    device_mod.LAUNCHES["splat"] += 1
    return grid


def splat_priority_grid(
    cell: torch.Tensor, key: torch.Tensor, ok: torch.Tensor, img_h: int, img_w: int
) -> torch.Tensor:
    """(B, img_h*img_w) int32 max key per cell, -1 where no point landed.

    A CPU tensor takes the plain version; a CUDA tensor launches B1.
    """
    if cell.device.type == "cpu":
        return splat_priority_grid_plain(cell, key, ok, img_h, img_w)
    if cell.device.type == "cuda":
        return splat_priority_grid_cuda(cell, key, ok, img_h, img_w)
    raise ValueError(f"unsupported device {cell.device}")


def splat_keys(
    xy_img: torch.Tensor, z: torch.Tensor, valid: torch.Tensor, img_h: int, img_w: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(cell, key, ok) of every point: B1's inputs (bev.py:145-165)."""
    b, n = z.shape
    x, y = xy_img[..., 0], xy_img[..., 1]
    in_bounds = (x >= 0) & (x < img_w) & (y >= 0) & (y < img_h)
    z_bin = torch.floor(div_const(z - ZMIN, ZMAX - ZMIN) * NUM_Z_SLICES).to(torch.int32)
    in_zrange = (z >= ZMIN) & (z < ZMAX)
    ok = valid & in_bounds & in_zrange
    idx = torch.arange(n, dtype=torch.int32, device=z.device)
    key = z_bin * n + idx[None, :]
    cell = (y * img_w + x).to(torch.int32)
    return cell.contiguous(), key.contiguous(), ok.contiguous()


def splat_zorder_batched(
    xy_img: torch.Tensor,
    z: torch.Tensor,
    rgb: torch.Tensor,
    valid: torch.Tensor,
    img_h: int,
    img_w: int,
    quantize_u8: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched z-order splat (salve_tpu/ops/bev.py:103).

    Args:
        xy_img: (B, N, 2) int32 pixel coordinates (x, y).
        z: (B, N) float32 heights in meters.
        rgb: (B, N, 3) float32 colours.
        valid: (B, N) bool; invalid points are dropped.
        quantize_u8: fetch the winners' colours as one packed rgb888 int32
            gather; the sparse colours come back as round(clip(rgb, 0, 255)).

    Returns:
        sparse: (B, H, W, 3) float32 colours, 0 where empty.
        occupied: (B, H, W) bool.
    """
    b, n = z.shape
    cell, key, ok = splat_keys(xy_img, z, valid, img_h, img_w)
    grid = splat_priority_grid(cell, key, ok, img_h, img_w)

    occupied = grid >= 0
    winner = torch.where(occupied, grid % n, torch.zeros_like(grid)).long()
    if quantize_u8:
        rgb_i = torch.clamp(torch.round(rgb), 0, 255).to(torch.int32)
        packed = (rgb_i[..., 0] << 16) | (rgb_i[..., 1] << 8) | rgb_i[..., 2]
        got = torch.gather(packed, 1, winner)
        cols = torch.stack([(got >> 16) & 0xFF, (got >> 8) & 0xFF, got & 0xFF], dim=-1)
        sparse = torch.where(occupied[..., None], cols.to(torch.float32), 0.0)
    else:
        got = torch.gather(rgb, 1, winner[..., None].expand(b, -1, 3))
        sparse = torch.where(occupied[..., None], got, 0.0)
    return sparse.reshape(b, img_h, img_w, 3), occupied.reshape(b, img_h, img_w)
