"""Fused BEV hole fill + hallucination mask (kernel B2).

Port of salve_tpu/ops/pallas_fill.py:fill_and_mask_batched and of its
oracle, salve_tpu/ops/bev.py:fill_holes + hallucination_mask, with the
kernel as `csrc/fill.cu`.

The plain version sums with exact shifted adds in the add order of
pallas_fill.py:_box_sum, never with `F.conv2d`: a float32 cuDNN convolution
runs in TF32 by default, the same trap as the TPU's bf16 conv passes
(bev.py:63-66). With that order the kernel, the plain version and the JAX
package agree bit for bit.
"""

from __future__ import annotations

import torch

from salve_tpu_torch import device as device_mod
from salve_tpu_torch.ops import kernels

# salve_tpu/ops/bev.py:45-50.
DEFAULT_MASK_KERNEL = 11
FILL_ITERS = 6


def box_sum(x: torch.Tensor, k: int) -> torch.Tensor:
    """Separable k x k box sum of (..., H, W) planes, zero-padded.

    Rows first, ((x + x[y-1]) + x[y+1]) + ..., then columns the same way —
    the order of salve_tpu/ops/pallas_fill.py:_box_sum. A neighbour outside
    the plane adds nothing (the reference adds its zero padding, which
    leaves every sum as it is).
    """
    r = k // 2
    rows = x.clone()
    for d in range(1, r + 1):
        rows[..., d:, :] += x[..., :-d, :]
        rows[..., :-d, :] += x[..., d:, :]
    out = rows.clone()
    for d in range(1, r + 1):
        out[..., :, d:] += rows[..., :, :-d]
        out[..., :, :-d] += rows[..., :, d:]
    return out


def support_mask(support: torch.Tensor, k: int = DEFAULT_MASK_KERNEL) -> torch.Tensor:
    """(..., H, W) bool: cells with >= 1 support cell in their k x k window."""
    return box_sum(support.to(torch.float32), k) > 0.5


def fill_holes(sparse: torch.Tensor, occupied: torch.Tensor, iters: int = FILL_ITERS) -> torch.Tensor:
    """Dilation-average hole fill of (..., H, W, 3) images with (..., H, W)
    occupancy (salve_tpu/ops/bev.py:fill_holes): each round gives empty
    cells the 3x3 box average of filled neighbours. Plain torch on any
    device."""
    lead, (h, w) = sparse.shape[:-3], sparse.shape[-3:-1]
    img = sparse.reshape(-1, h, w, 3).permute(0, 3, 1, 2).to(torch.float32).contiguous()  # (B, 3, H, W)
    o = occupied.reshape(-1, 1, h, w).to(torch.float32)  # (B, 1, H, W)
    for _ in range(iters):
        den = box_sum(o, 3)
        fill = box_sum(img * o, 3).div_(torch.clamp(den, min=1.0))
        img = torch.where(o > 0, img, fill)
        o = torch.maximum(o, den.clamp_(0.0, 1.0))
    return img.permute(0, 2, 3, 1).reshape(lead + (h, w, 3))


def fill_and_mask_plain(
    sparse: torch.Tensor, occupied: torch.Tensor, support: torch.Tensor
) -> torch.Tensor:
    """Plain version of B2: (B, H, W, 3) f32, (B, H, W) bool x2 -> (B, H, W, 3)."""
    img = fill_holes(sparse, occupied)
    out = torch.where(support_mask(support)[..., None], img, torch.zeros_like(img))
    return out.contiguous()


def fill_and_mask_cuda(
    sparse: torch.Tensor, occupied: torch.Tensor, support: torch.Tensor
) -> torch.Tensor:
    """Launch B2 on the card; raises on anything but contiguous CUDA input."""
    device_mod.require_cuda_tensor("sparse", sparse, torch.float32)
    device_mod.require_cuda_tensor("occupied", occupied, torch.bool)
    device_mod.require_cuda_tensor("support", support, torch.bool)
    if sparse.dim() != 4 or sparse.shape[-1] != 3:
        raise ValueError(f"sparse must be (B, H, W, 3), got {tuple(sparse.shape)}")
    b, h, w, _ = sparse.shape
    if occupied.shape != (b, h, w) or support.shape != (b, h, w):
        raise ValueError("occupied and support must be (B, H, W) like sparse")
    if sparse.data_ptr() % 16:  # the kernel reads colour rows as 16-byte vectors
        raise ValueError("sparse must start on a 16-byte boundary")
    out = torch.empty_like(sparse)  # a fresh allocation: 16-byte aligned
    lib = kernels.load().lib
    err = lib.salve_fill_mask(
        sparse.data_ptr(), occupied.data_ptr(), support.data_ptr(), out.data_ptr(),
        b, h, w, kernels.stream_handle(sparse.device),
    )
    kernels.check(err, "fill")
    device_mod.count_launch("fill")
    return out


def fill_and_mask(
    sparse: torch.Tensor, occupied: torch.Tensor, support: torch.Tensor
) -> torch.Tensor:
    """Hole fill + hallucination mask of a batch, any batch and grid size.

    Args:
        sparse: (B, H, W, 3) float32 splatted colours.
        occupied: (B, H, W) bool splat occupancy.
        support: (B, H, W) bool, all three u8-quantized channels > 0.

    A CPU tensor takes the plain version; a CUDA tensor launches B2.
    """
    if sparse.device.type == "cpu":
        return fill_and_mask_plain(sparse, occupied, support)
    if sparse.device.type == "cuda":
        return fill_and_mask_cuda(sparse, occupied, support)
    raise ValueError(f"unsupported device {sparse.device}")
