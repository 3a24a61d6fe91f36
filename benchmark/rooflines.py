"""Peaks of the cards and the least time each hand-written kernel needs.

A kernel's roofline share is its least time over its measured time: the
larger of (bytes it must move) / (the card's memory bandwidth) and (float
operations it must do) / (the card's float32 rate). Each input byte is
counted once and each output byte once, from the launch's shapes; a count
that depends on the data (B3's reads) is taken from the data.
"""

from __future__ import annotations

from typing import Dict, Optional

# Published dense peaks (NVIDIA H100 data sheet, SXM5), at a 700 W limit.
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}

# Float operations a cell of B2 does: 6 fill rounds of 17 (row pass) + 15
# (column pass and update), and 22 adds for the 11x11 support count.
FILL_OPS_PER_CELL = 6 * (17 + 15) + 22


def peaks(kind: str) -> Optional[Dict[str, float]]:
    return PEAKS.get(kind)


def splat_bytes(b: int, n: int, cells: int) -> int:
    """B1: cell and key (int32) and ok (bool) of each point in, one int32 a
    grid cell out."""
    return b * n * 9 + b * cells * 4


def fill_bytes(b: int, h: int, w: int) -> int:
    """B2: float32 rgb, occupancy and support (bool) in, float32 rgb out."""
    return b * h * w * 26


def fill_ops(b: int, h: int, w: int) -> int:
    return b * h * w * FILL_OPS_PER_CELL


def warp_bytes(b: int, d: int, x3: int, y2: int, n_banks: int, reads: int) -> int:
    """B3: u8 rgb out of each bank, the bank words the outputs read
    (`reads`, summed over the banks), the int32 pass parameters and the
    int64 bank row of each image."""
    return n_banks * b * d * d * 3 + reads * 4 + b * (y2 + x3 + d + 2) * 4 + b * 8


def least_seconds(bytes_: float, ops: float, kind: str) -> Optional[float]:
    p = peaks(kind)
    if p is None:
        return None
    return max(bytes_ / p["hbm_bytes_per_s"], ops / p["fp32_flops"])


def warp_reads(row0, starts1, starts2, starts3, d: int, x3: int, y2: int, side: int) -> int:
    """Outputs of one bank in a B3 launch whose three-pass chain lands in
    the source (each reads one bank word), from the launch's pass
    parameters: row0 (B,), starts1 (B, y2), starts2 (B, x3), starts3 (B, d)."""
    import torch

    dev = row0.device
    rows = row0.long()[:, None] + torch.arange(y2, device=dev)
    c1 = starts1.long()[..., None] + torch.arange(x3, device=dev)
    m1 = ((rows >= 0) & (rows < side))[..., None] & (c1 >= 0) & (c1 < side)  # (B, y2, x3)
    c2 = starts2.long()[..., None] + torch.arange(d, device=dev)  # (B, x3, d)
    m2 = torch.gather(m1.transpose(1, 2), 2, c2.clamp(0, y2 - 1)) & (c2 >= 0) & (c2 < y2)
    c3 = starts3.long()[..., None] + torch.arange(d, device=dev)  # (B, d, d)
    m3 = torch.gather(m2.transpose(1, 2).contiguous(), 2, c3.clamp(0, x3 - 1)) & (c3 >= 0) & (c3 < x3)
    return int(m3.sum())
