"""Polygon fill in PyTorch: the even-odd crossing test of the JAX package.

Port of `polygon_mask` (salve_tpu/ops/raster.py:33-69), which the floor
report uses to rasterize room layouts for the floorplan IoU. It is plain XLA
in the JAX package, not a Pallas kernel, so plain PyTorch is its port.

The mask is bit-exact to JAX's: the edge/scanline intersection is the same
float32 expression, one elementwise op per step (each rounded to float32, so
no fused multiply-add can move a tie), and the crossing count is an integer.
Two rewrites change no value: the intersection, which depends only on the
row, is computed once a row instead of once a pixel, and edges past the
longest polygon of a batch are not visited (JAX masks padded edges out).

`polyline_coverage` and `paint_rgb` come with the file-contract renderer.
"""

from __future__ import annotations

import torch


def polygon_mask(
    verts_xy: torch.Tensor,
    num_verts: torch.Tensor,
    img_h: int,
    img_w: int,
) -> torch.Tensor:
    """Even-odd rasterization of closed polygons into (..., H, W) bool masks.

    Args:
        verts_xy: (..., V, 2) float32 image-space vertices, padded; vertex i
            connects to vertex (i + 1) % num_verts.
        num_verts: (...) integer counts of real vertices (<= V).
        img_h, img_w: raster dimensions.
    """
    dev = verts_xy.device
    num_verts = torch.as_tensor(num_verts)  # counts given on the host stay there for the max
    v = max(int(num_verts.max()), 1) if num_verts.numel() else 1
    num_verts = num_verts.to(dev)
    verts_xy = verts_xy[..., :v, :]
    idx = torch.arange(v, device=dev)
    n = num_verts[..., None]
    nxt = torch.where(idx + 1 >= n, 0, idx + 1)  # (..., V)
    edge_valid = idx < n

    p1 = torch.gather(verts_xy, -2, nxt[..., None].expand(*nxt.shape, 2))
    # (..., 1, 1, V) edge ends against (H, 1, 1) rows and (W, 1) columns.
    x0, y0 = verts_xy[..., None, None, :, 0], verts_xy[..., None, None, :, 1]
    x1, y1 = p1[..., None, None, :, 0], p1[..., None, None, :, 1]
    ys = torch.arange(img_h, dtype=torch.float32, device=dev)[:, None, None]
    xs = torch.arange(img_w, dtype=torch.float32, device=dev)[:, None]

    cond = (y0 > ys) != (y1 > ys)  # (..., H, 1, V)
    dy = y1 - y0
    denom = torch.where(torch.abs(dy) < 1e-12, torch.tensor(1e-12, dtype=torch.float32, device=dev), dy)
    x_int = x0 + (ys - y0) * (x1 - x0) / denom  # (..., H, 1, V)
    hit = (cond & edge_valid[..., None, None, :]) & (xs < x_int)  # (..., H, W, V)
    crossings = hit.sum(dim=-1, dtype=torch.int32)
    return (crossings % 2) == 1
