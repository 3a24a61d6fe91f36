"""Sim(2) BEV warp: hypothesis renders from banked identity renders (kernel B3).

Port of salve_tpu/ops/warp.py. Each pano is rendered once per surface into
an extended identity bank (packed rgb888 int32;
rendering/bev_pair.py:render_identity_banks); every hypothesis render of
pano 1 is then a nearest-neighbour Sim(2) resample of that bank.

Two warps, as in the JAX package:
  * `warp_bank_sim2_nn` — one exact NN gather per output cell;
  * `warp_bank_sim2_shear` — the 3-shear (Paeth) factorization, NN-rounded
    per pass; its CUDA kernel is `csrc/warp.cu` (replacing
    salve_tpu/ops/pallas_warp.py:warp_bank_sim2_shear_pallas_v2).
`warp_bank_sim2_nn_host` is the numpy copy of the NN gather that the corpus
renderer (rendering/dataset_renderer.py) runs on the host.
`warp_banks_auto` dispatches like JAX's: the shear kernel on the card (one
launch for a batch's ceiling and floor banks), the NN gather on the CPU.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from salve_tpu_torch import device as device_mod
from salve_tpu_torch.ops import kernels
from salve_tpu_torch.ops.bev import DEFAULT_BEV_IMG_PX, DEFAULT_METERS_PER_PX
from salve_tpu_torch.ops.numerics import div_const, fma_f32

# Target-grid world coordinates of the host warp, by (H, W, mpp, half extent).
_HOST_GRID_CACHE: dict = {}

_TAN22 = 0.4142135623730951  # tan(pi/8): max |shear a| after the 90-deg reduction
_SIN45 = 0.7071067811865476  # sin(pi/4): max |shear s|


def pack_rgb888(imgs_u8: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 -> (...) int32 packed 0xRRGGBB (bank storage format)."""
    x = imgs_u8.to(torch.int32)
    return (x[..., 0] << 16) | (x[..., 1] << 8) | x[..., 2]


def unpack_rgb888(got: torch.Tensor) -> torch.Tensor:
    """(...) int32 packed 0xRRGGBB -> (..., 3) uint8."""
    return torch.stack([(got >> 16) & 0xFF, (got >> 8) & 0xFF, got & 0xFF], dim=-1).to(torch.uint8)


def _bank_rows(bank: torch.Tensor, bank_idx: Optional[torch.Tensor], b: int) -> torch.Tensor:
    if bank_idx is None:
        if bank.shape[0] != b:
            raise ValueError(f"bank has {bank.shape[0]} rows for {b} hypotheses and no bank_idx")
        return torch.arange(b, device=bank.device)
    return bank_idx.to(device=bank.device, dtype=torch.long)


def warp_bank_sim2_nn(
    bank: torch.Tensor,
    i2Ri1: torch.Tensor,
    i2ti1_scaled: torch.Tensor,
    dst_img_px: int = DEFAULT_BEV_IMG_PX,
    meters_per_px: float = DEFAULT_METERS_PER_PX,
    bank_idx: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Nearest-neighbour Sim(2) warp of banked identity renders.

    Args:
        bank: (P, S, S) int32 packed rgb888 identity renders, in the stored
            (vertically flipped) orientation.
        i2Ri1: (B, 2, 2) relative rotation (target world <- source world).
        i2ti1_scaled: (B, 2) relative translation in target world meters,
            already carrying the 1.5 HoHoNet scale.
        bank_idx: (B,) bank row of each hypothesis; None means P == B.

    Returns:
        (B, dst_img_px+1, dst_img_px+1, 3) uint8; 0 where the sample falls
        outside the bank or the bank is empty there.
    """
    b = i2Ri1.shape[0]
    rows = _bank_rows(bank, bank_idx, b)
    _, src_h, src_w = bank.shape
    dev = bank.device
    dst_h = dst_w = dst_img_px + 1
    half_dst = int((dst_img_px / 2) * meters_per_px)
    half_src = int(((src_h - 1) / 2) * meters_per_px)

    px = torch.arange(dst_w, dtype=torch.float32, device=dev)[None, :].expand(dst_h, dst_w)
    py_stored = torch.arange(dst_h, dtype=torch.float32, device=dev)[:, None].expand(dst_h, dst_w)
    py = (dst_h - 1) - py_stored  # pre-flip row
    wx = fma_f32(px, meters_per_px, -half_dst)
    wy = fma_f32(py, meters_per_px, -half_dst)

    R = i2Ri1.to(torch.float32)
    t = i2ti1_scaled.to(torch.float32)
    rx = wx[None] - t[:, 0, None, None]
    ry = wy[None] - t[:, 1, None, None]
    # Source world = R^T (target world - t).
    sx = R[:, 0, 0, None, None] * rx + R[:, 1, 0, None, None] * ry
    sy = R[:, 0, 1, None, None] * rx + R[:, 1, 1, None, None] * ry

    qx = torch.round(div_const(sx + half_src, meters_per_px)).to(torch.int32)
    qy = torch.round(div_const(sy + half_src, meters_per_px)).to(torch.int32)
    inb = (qx >= 0) & (qx < src_w) & (qy >= 0) & (qy < src_h)
    qy_stored = (src_h - 1) - qy

    flat = torch.where(inb, qy_stored * src_w + qx, torch.zeros_like(qx)).long()
    page = rows[:, None, None] * (src_h * src_w)
    got = bank.reshape(-1)[page + flat]
    got = torch.where(inb, got, torch.zeros_like(got))
    return unpack_rgb888(got)


def warp_bank_sim2_nn_host(
    bank_packed: np.ndarray,
    i2Ri1: np.ndarray,
    i2ti1_scaled: np.ndarray,
    dst_img_px: int = DEFAULT_BEV_IMG_PX,
    meters_per_px: float = DEFAULT_METERS_PER_PX,
    bank_idx: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Numpy copy of salve_tpu/ops/warp.py:warp_bank_sim2_nn_host, the
    corpus renderer's host warp: bit-equal to it and to `warp_bank_sim2_nn`.

    The corpus lands every image on the host as JPEG bytes, so the banks are
    fetched once a floor and each hypothesis is warped here.

    Args:
        bank_packed: (B, Hs, Ws) int32 packed rgb888, one source per output
            image, or with `bank_idx` the whole (P, Hs, Ws) pano bank.
        bank_idx: optional (B,) rows of a (P, ...) `bank_packed`; the gather
            then reads the bank in place instead of copying B sources.
    """
    packed = bank_packed
    if bank_idx is None:
        b, src_h, src_w = packed.shape
    else:
        b = len(bank_idx)
        _, src_h, src_w = packed.shape
    dst_h = dst_w = dst_img_px + 1
    half_dst = int((dst_img_px / 2) * meters_per_px)
    half_src = int(((src_h - 1) / 2) * meters_per_px)

    key = (dst_h, dst_w, float(meters_per_px), half_dst)
    w = _HOST_GRID_CACHE.get(key)
    if w is None:
        px = np.broadcast_to(np.arange(dst_w, dtype=np.float32)[None, :], (dst_h, dst_w))
        py_stored = np.broadcast_to(np.arange(dst_h, dtype=np.float32)[:, None], (dst_h, dst_w))
        py = (dst_h - 1) - py_stored
        wx = px * np.float32(meters_per_px) - np.float32(half_dst)
        wy = py * np.float32(meters_per_px) - np.float32(half_dst)
        w = np.stack([wx, wy], axis=-1)  # (H, W, 2)
        _HOST_GRID_CACHE[key] = w
    w_rel = w[None] - i2ti1_scaled.astype(np.float32)[:, None, None, :]
    w_src = np.einsum("bji,bhwj->bhwi", i2Ri1.astype(np.float32), w_rel).astype(np.float32)

    qx = np.round((w_src[..., 0] + np.float32(half_src)) / np.float32(meters_per_px)).astype(np.int32)
    qy = np.round((w_src[..., 1] + np.float32(half_src)) / np.float32(meters_per_px)).astype(np.int32)
    inb = (qx >= 0) & (qx < src_w) & (qy >= 0) & (qy < src_h)
    qy_stored = (src_h - 1) - qy

    flat = np.where(inb, qy_stored * src_w + qx, 0)
    if bank_idx is None:
        got = np.take_along_axis(packed.reshape(b, src_h * src_w), flat.reshape(b, -1), axis=1).reshape(
            b, dst_h, dst_w)
    else:
        page = np.asarray(bank_idx, dtype=np.int64)[:, None, None] * (src_h * src_w)
        got = packed.reshape(-1)[page + flat]
    got = np.where(inb, got, 0)
    return np.stack([(got >> 16) & 0xFF, (got >> 8) & 0xFF, got & 0xFF], axis=-1).astype(np.uint8)


# ---------------------------------------------------------------------------
# Shear-decomposition NN warp.
# ---------------------------------------------------------------------------


class ShearParams(NamedTuple):
    """Per-image integer parameters of the 3-shear warp (warp.py:350-397)."""

    n: torch.Tensor  # (B,) int32 rot90 count
    row0: torch.Tensor  # (B,) int32 first source row of pass 1
    starts1: torch.Tensor  # (B, y2) int32
    starts2: torch.Tensor  # (B, x3) int32
    starts3: torch.Tensor  # (B, d) int32
    d: int  # output side
    x3: int  # pass-3 lane extent
    y2: int  # pass-2 row extent


def _shear_params(i2Ri1, i2ti1_scaled, src_half_m, dst_half_m, meters_per_px):
    """Per-image (n, a, s, phi, b2) of the 90-deg-reduced 3-shear factorization.

    q = A p + b with A = R^T (target px -> source px, both pre-flip); A is
    reduced to rot(phi) . Q^n (Q = rot90, phi in [-45, 45]) and rot(phi) =
    Shx(a) . Shy(s) . Shx(a) with a = -tan(phi/2), s = sin(phi).
    """
    m = meters_per_px
    A = i2Ri1.transpose(-1, -2)
    tx, ty = i2ti1_scaled[..., 0], i2ti1_scaled[..., 1]
    b0 = div_const(src_half_m - (A[..., 0, 0] * (dst_half_m + tx) + A[..., 0, 1] * (dst_half_m + ty)), m)
    b1 = div_const(src_half_m - (A[..., 1, 0] * (dst_half_m + tx) + A[..., 1, 1] * (dst_half_m + ty)), m)
    psi = torch.atan2(A[..., 1, 0], A[..., 0, 0])
    k = torch.round(div_const(psi, math.pi / 2))
    n = k.to(torch.int32) % 4
    phi = psi - k * (math.pi / 2)
    a = -torch.tan(div_const(phi, 2))
    s = torch.sin(phi)
    return n, a, s, phi, torch.stack([b0, b1], dim=-1)


def _q_center_correction(n, phi, c):
    """b2 term from rotating the target grid about its center c = (D-1)/2.

    The table [[0, 0], [-2, 0], [-2, -2], [0, -2]] * c of n, built with
    selects on the device (a host-made table would be a blocking copy)."""
    zero = torch.zeros((), dtype=torch.float32, device=phi.device)
    m2c = torch.full((), -2.0 * c, dtype=torch.float32, device=phi.device)
    qc = torch.stack(
        [torch.where((n == 1) | (n == 2), m2c, zero), torch.where((n == 2) | (n == 3), m2c, zero)], dim=-1
    )
    cos, sin = torch.cos(phi), torch.sin(phi)
    return torch.stack(
        [cos * qc[..., 0] - sin * qc[..., 1], sin * qc[..., 0] + cos * qc[..., 1]], dim=-1
    )


def shear_warp_params(
    i2Ri1: torch.Tensor,
    i2ti1_scaled: torch.Tensor,
    src_px: int,
    dst_img_px: int = DEFAULT_BEV_IMG_PX,
    meters_per_px: float = DEFAULT_METERS_PER_PX,
) -> ShearParams:
    """Integer pass parameters of the shear warp, computed outside B3."""
    d = dst_img_px + 1
    half_dst = int((dst_img_px / 2) * meters_per_px)
    half_src = int(((src_px - 1) / 2) * meters_per_px)
    x3 = d + int(math.ceil(_TAN22 * (d - 1)))
    y2 = d + int(math.ceil(_SIN45 * (x3 - 1)))
    dev = i2Ri1.device

    n, a, s, phi, b2 = _shear_params(
        i2Ri1.to(torch.float32), i2ti1_scaled.to(torch.float32),
        half_src, half_dst, meters_per_px,
    )
    b2 = b2 + _q_center_correction(n, phi, (d - 1) / 2.0)

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    o3 = torch.minimum(zero, torch.round(a * (d - 1))).to(torch.int32)
    x3_log = torch.arange(x3, dtype=torch.float32, device=dev)[None, :] + o3[:, None]
    r2 = torch.round(s[:, None] * x3_log).to(torch.int32)
    o2 = torch.clamp(r2.amin(dim=1), max=0)

    y2_log = torch.arange(y2, dtype=torch.float32, device=dev)[None, :] + o2[:, None]
    row0 = (y2_log[:, 0] + torch.round(b2[:, 1])).to(torch.int32)
    starts1 = (o3[:, None] + torch.round(a[:, None] * y2_log + b2[:, 0:1])).to(torch.int32)
    starts2 = r2 - o2[:, None]
    v_idx = torch.arange(d, dtype=torch.float32, device=dev)[None, :]
    starts3 = (torch.round(a[:, None] * v_idx) - o3[:, None]).to(torch.int32)
    return ShearParams(
        n=n.contiguous(), row0=row0.contiguous(), starts1=starts1.contiguous(),
        starts2=starts2.contiguous(), starts3=starts3.contiguous(), d=d, x3=x3, y2=y2,
    )


def _row_slice(img: torch.Tensor, starts: torch.Tensor, span: int) -> torch.Tensor:
    """out[b, r, k] = img[b, r, starts[b, r] + k], 0 outside [0, W)."""
    w = img.shape[-1]
    cols = starts.long()[..., None] + torch.arange(span, device=img.device)
    ok = (cols >= 0) & (cols < w)
    got = torch.gather(img, 2, cols.clamp(0, w - 1))
    return torch.where(ok, got, torch.zeros_like(got))


def shear_warp_plain(
    bank: torch.Tensor, bank_idx: torch.Tensor, p: ShearParams
) -> torch.Tensor:
    """Plain version of B3: the three row-slice passes, then rot90^n and flip.

    A bank row outside [0, P) reads as an empty page (all zeros), as in B3.
    """
    s = bank.shape[-1]
    d = p.d
    rows_idx = bank_idx.long()
    in_bank = (rows_idx >= 0) & (rows_idx < bank.shape[0])
    srcp = torch.flip(bank[rows_idx.clamp(0, bank.shape[0] - 1)], dims=[1])  # stored -> pre-flip rows
    srcp = torch.where(in_bank[:, None, None], srcp, torch.zeros_like(srcp))
    b = srcp.shape[0]

    # Pass 1: rows row0 + y (zero outside the source), then per-row x-shear.
    r = p.row0.long()[:, None] + torch.arange(p.y2, device=bank.device)  # (B, y2)
    r_ok = (r >= 0) & (r < s)
    rows = torch.gather(srcp, 1, r.clamp(0, s - 1)[..., None].expand(b, p.y2, s))
    rows = torch.where(r_ok[..., None], rows, torch.zeros_like(rows))
    i1 = _row_slice(rows, p.starts1, p.x3)  # (B, y2, x3)
    # Pass 2 on the transpose: y-shear.
    i2 = _row_slice(i1.transpose(1, 2).contiguous(), p.starts2, d).transpose(1, 2)  # (B, d, x3)
    # Pass 3: x-shear.
    t1 = _row_slice(i2.contiguous(), p.starts3, d)  # (B, d, d)

    variants = torch.stack(
        [
            t1,
            torch.flip(t1, dims=[2]).transpose(1, 2),
            torch.flip(t1, dims=[1, 2]),
            torch.flip(t1, dims=[1]).transpose(1, 2),
        ],
        dim=1,
    )
    outp = variants[torch.arange(b, device=bank.device), p.n.long()]
    return unpack_rgb888(torch.flip(outp, dims=[1]))


def shear_warp_cuda(banks, bank_idx: torch.Tensor, p: ShearParams):
    """Launch B3 on the card; raises on anything but contiguous CUDA input.

    `banks` is one (P, S, S) bank, or a tuple of up to two banks of one shape
    (a batch's ceiling and floor) warped by the same rows and parameters in
    one launch; the result is one (B, d, d, 3) uint8 tensor, or a tuple.
    A bank row outside [0, P) reads as an empty page, as in the plain
    version; the rows are not checked on the host, which would synchronise.
    """
    single = isinstance(banks, torch.Tensor)
    banks = (banks,) if single else tuple(banks)
    if not 1 <= len(banks) <= 2:
        raise ValueError(f"one launch warps one or two banks, got {len(banks)}")
    for k, bank in enumerate(banks):
        device_mod.require_cuda_tensor(f"bank {k}", bank, torch.int32)
        if bank.shape != banks[0].shape:
            raise ValueError(f"banks differ in shape: {tuple(bank.shape)} vs {tuple(banks[0].shape)}")
    device_mod.require_cuda_tensor("bank_idx", bank_idx, torch.int64)
    for name in ("n", "row0", "starts1", "starts2", "starts3"):
        device_mod.require_cuda_tensor(name, getattr(p, name), torch.int32)
    bank = banks[0]
    if bank.dim() != 3 or bank.shape[1] != bank.shape[2]:
        raise ValueError(f"bank must be (P, S, S), got {tuple(bank.shape)}")
    b = bank_idx.shape[0]
    if b > 65535:  # the batch is the launch grid's z extent
        raise ValueError(f"at most 65535 hypotheses a launch, got {b}")
    if (
        p.n.shape != (b,) or p.row0.shape != (b,) or p.starts1.shape != (b, p.y2)
        or p.starts2.shape != (b, p.x3) or p.starts3.shape != (b, p.d)
    ):
        raise ValueError("shear parameters do not match the batch")
    s = bank.shape[-1]
    outs = tuple(
        torch.empty((b, p.d, p.d, 3), dtype=torch.uint8, device=bank.device) for _ in banks
    )
    second = banks[-1]
    lib = kernels.load().lib
    err = lib.salve_shear_warp(
        bank.data_ptr(), second.data_ptr(), bank_idx.data_ptr(), p.n.data_ptr(),
        p.row0.data_ptr(), p.starts1.data_ptr(), p.starts2.data_ptr(), p.starts3.data_ptr(),
        outs[0].data_ptr(), outs[-1].data_ptr(), len(banks),
        b, bank.shape[0], s, p.d, p.x3, p.y2, kernels.stream_handle(bank.device),
    )
    kernels.check(err, "warp")
    device_mod.count_launch("warp")
    return outs[0] if single else outs


def shear_warp(bank: torch.Tensor, bank_idx: torch.Tensor, p: ShearParams) -> torch.Tensor:
    """(B, d, d, 3) uint8 shear warp of bank rows `bank_idx` with parameters `p`.

    A CPU tensor takes the plain version; a CUDA tensor launches B3.
    """
    if bank.device.type == "cpu":
        return shear_warp_plain(bank, bank_idx, p)
    if bank.device.type == "cuda":
        return shear_warp_cuda(bank, bank_idx, p)
    raise ValueError(f"unsupported device {bank.device}")


def warp_bank_sim2_shear(
    bank: torch.Tensor,
    i2Ri1: torch.Tensor,
    i2ti1_scaled: torch.Tensor,
    dst_img_px: int = DEFAULT_BEV_IMG_PX,
    meters_per_px: float = DEFAULT_METERS_PER_PX,
    bank_idx: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """3-shear NN Sim(2) warp, plain version (salve_tpu/ops/warp.py:331).

    Same contract as warp_bank_sim2_nn; packed (P, S, S) int32 banks only.
    """
    if bank.dim() != 3:
        raise ValueError("shear warp expects packed rgb888 banks")
    rows = _bank_rows(bank, bank_idx, i2Ri1.shape[0])
    p = shear_warp_params(i2Ri1, i2ti1_scaled, bank.shape[1], dst_img_px, meters_per_px)
    return shear_warp_plain(bank, rows, p)


def warp_banks_auto(
    banks: Sequence[torch.Tensor],
    i2Ri1: torch.Tensor,
    i2ti1_scaled: torch.Tensor,
    dst_img_px: int = DEFAULT_BEV_IMG_PX,
    meters_per_px: float = DEFAULT_METERS_PER_PX,
    bank_idx: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """Production warp dispatch for banks that share rows and hypotheses
    (salve_tpu/ops/warp.py:428, once for each bank).

    On CUDA banks: the shear parameters once, in PyTorch, then one launch of
    kernel B3 for every bank (at most two, a batch's ceiling and floor),
    which reads the banks in place through `bank_idx`. On CPU banks: the
    exact NN gather of each, as JAX's own dispatch does off the TPU.

    Returns one (B, dst_img_px+1, dst_img_px+1, 3) uint8 warp a bank.
    """
    banks = tuple(banks)
    if banks[0].device.type == "cuda":
        rows = _bank_rows(banks[0], bank_idx, i2Ri1.shape[0])
        p = shear_warp_params(i2Ri1, i2ti1_scaled, banks[0].shape[1], dst_img_px, meters_per_px)
        return shear_warp_cuda(tuple(b.contiguous() for b in banks), rows.contiguous(), p)
    return tuple(
        warp_bank_sim2_nn(b, i2Ri1, i2ti1_scaled, dst_img_px, meters_per_px, bank_idx) for b in banks
    )


def warp_bank_auto(
    bank_packed: torch.Tensor,
    i2Ri1: torch.Tensor,
    i2ti1_scaled: torch.Tensor,
    dst_img_px: int = DEFAULT_BEV_IMG_PX,
    meters_per_px: float = DEFAULT_METERS_PER_PX,
    bank_idx: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Production warp dispatch of one bank (salve_tpu/ops/warp.py:428):
    `warp_banks_auto` with a single bank."""
    return warp_banks_auto((bank_packed,), i2Ri1, i2ti1_scaled, dst_img_px, meters_per_px, bank_idx)[0]
