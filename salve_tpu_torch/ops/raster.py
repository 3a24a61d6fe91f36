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

`points_in_polygon_grid` is stitching's raster containment: the float64
numpy test of salve_tpu/geometry/polygons.py:29 on every cell of a grid,
which room grouping and the stitch IoU run (salve_tpu/algorithms/
room_merging.py:23, salve_tpu/stitching/shape.py:249). It is plain numpy in
the JAX package, so plain torch is its port, here float64 on the polygon's
device.

`polyline_coverage` and `paint_rgb` (salve_tpu/ops/raster.py:73, :123) draw
the layout modality's thick W/D/O lines (rendering/layout.py). They are plain
XLA in the JAX package, so plain torch is their port: float32 on the
vertices' device, op for op as XLA:CPU computes them, so that the u8 images
after round/clip equal the reference's (`div_const` for the division by the
ramp, an IEEE sqrt for the norm).
"""

from __future__ import annotations

import torch

from salve_tpu_torch.ops.numerics import div_const, fma_f32_exact, sqrt_f32

# Elements (rows x columns x edges) of one chunk of `points_in_polygon_grid`:
# a 4000^2 grid against a 1024-vertex ring is 16e9 and is never allocated.
GRID_CHUNK_ELEMENTS = 1 << 25
# Edges of one chunk of `polygon_mask`'s crossing count.
EDGE_CHUNK = 32


def points_in_polygon_grid(polygon: torch.Tensor, xs, ys) -> torch.Tensor:
    """(ny, nx) bool even-odd mask of the grid `meshgrid(xs, ys)`.

    Exactly `points_in_polygon(polygon, grid).reshape(ny, nx)` of
    salve_tpu/geometry/polygons.py:29, computed on `polygon`'s device: the
    ring closes by a roll, a horizontal edge's denominator is 1.0, the
    crossing x is `x1 + ((qy - y1) * (x2 - x1)) / denom` with each step its
    own float64 op (nothing fuses into an FMA), and the crossing count is an
    integer taken mod 2. The crossing x depends on the row alone, so it is
    computed once a row instead of once a cell: the same values.

    Args:
        polygon: (M, 2) float64 ring (closure implicit).
        xs, ys: (nx,) and (ny,) float64 cell centres, numpy or torch, built
            on the host with the reference's expressions; copied to the
            polygon's device.
    """
    if polygon.dtype != torch.float64:
        raise ValueError(f"the polygon must be float64, got {polygon.dtype}")
    dev = polygon.device
    xs = torch.as_tensor(xs, dtype=torch.float64, device=dev)
    ys = torch.as_tensor(ys, dtype=torch.float64, device=dev)
    x1, y1 = polygon[:, 0], polygon[:, 1]
    x2, y2 = torch.roll(x1, -1), torch.roll(y1, -1)
    denom = y2 - y1
    denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    dx = x2 - x1
    nx, ny, m = xs.shape[0], ys.shape[0], polygon.shape[0]
    rows = max(1, GRID_CHUNK_ELEMENTS // max(nx * m, 1))
    out = torch.empty((ny, nx), dtype=torch.bool, device=dev)
    qx = xs[None, :, None]  # (1, nx, 1)
    for r0 in range(0, ny, rows):
        qy = ys[r0:r0 + rows, None]  # (rows, 1)
        straddles = (y1 > qy) != (y2 > qy)  # (rows, M)
        x_cross = x1 + ((qy - y1) * dx) / denom  # (rows, M)
        hit = straddles[:, None, :] & (qx < x_cross[:, None, :])  # (rows, nx, M)
        out[r0:r0 + rows] = hit.sum(dim=-1, dtype=torch.int32) % 2 == 1
    return out


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
    live = cond & edge_valid[..., None, None, :]
    # The (..., H, W, V) hits are summed EDGE_CHUNK edges at a time: a dense
    # MHNet boundary has ~600 vertices, and a batch of 64 such rooms at 501^2
    # would otherwise hold ~10 GB of hits. The integer sum is the same.
    crossings = None
    for e0 in range(0, v, EDGE_CHUNK):
        hit = live[..., e0:e0 + EDGE_CHUNK] & (xs < x_int[..., e0:e0 + EDGE_CHUNK])  # (..., H, W, chunk)
        part = hit.sum(dim=-1, dtype=torch.int32)
        crossings = part if crossings is None else crossings + part
    return (crossings % 2) == 1


# cv2.line(LINE_AA)'s measured profile (salve_tpu/ops/raster.py:polyline_coverage):
# 50% intensity at thickness / 2 + 0.65 px, a 1.25 px transition band.
AA_HALF_WIDTH_PAD = 0.65
AA_RAMP = 1.25


def polyline_coverage(
    verts_xy: torch.Tensor,
    num_verts: torch.Tensor,
    thickness: float,
    img_h: int,
    img_w: int,
) -> torch.Tensor:
    """Anti-aliased coverage in [0, 1] of thick open polylines, (..., H, W).

    Args:
        verts_xy: (..., V, 2) float32 image-space vertices, padded.
        num_verts: (...) counts of real vertices; segments are (i, i + 1)
            for i < num_verts - 1.
        thickness: line thickness in pixels.

    The distance to each segment is the endpoint-clamped projection's, its
    norm an IEEE sqrt of dx * dx + dy * dy; padded segments are +inf. The
    minimum over segments goes through the same ramp as the reference.
    """
    dev = verts_xy.device
    v = verts_xy.shape[-2]
    num_verts = torch.as_tensor(num_verts, device=dev)
    xs = torch.arange(img_w, dtype=torch.float32, device=dev)[None, :].expand(img_h, img_w)
    ys = torch.arange(img_h, dtype=torch.float32, device=dev)[:, None].expand(img_h, img_w)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    lead = verts_xy.shape[:-2]
    min_dist = torch.full((*lead, img_h, img_w), float("inf"), dtype=torch.float32, device=dev)
    for i in range(v - 1):  # segment V - 1 is never real (num_verts <= V)
        a = verts_xy[..., i, :]
        b = verts_xy[..., min(i + 1, v - 1), :]
        ax, ay = a[..., 0, None, None], a[..., 1, None, None]
        abx, aby = (b[..., 0] - a[..., 0])[..., None, None], (b[..., 1] - a[..., 1])[..., None, None]
        apx, apy = xs - ax, ys - ay
        # Two-term sums as XLA:CPU's reduce runs them: (0 + p0) + p1, the
        # second product fused into the add.
        ab_len2 = fma_f32_exact(aby, aby, abx * abx + zero)
        dot = fma_f32_exact(apy, aby, apx * abx + zero)
        t = torch.clamp(dot / torch.clamp(ab_len2, min=1e-12), 0.0, 1.0)
        dx = xs - fma_f32_exact(t, abx.expand_as(t), ax.expand_as(t))
        dy = ys - fma_f32_exact(t, aby.expand_as(t), ay.expand_as(t))
        dist = sqrt_f32(fma_f32_exact(dy, dy, dx * dx + zero))
        valid = (i < (num_verts - 1))[..., None, None]
        min_dist = torch.minimum(min_dist, torch.where(valid, dist, torch.full_like(dist, float("inf"))))
    half_width = float(torch.tensor(thickness, dtype=torch.float32) / 2.0 + AA_HALF_WIDTH_PAD)
    top = float(torch.tensor(half_width, dtype=torch.float32) + AA_RAMP / 2.0)
    return torch.clamp(div_const(top - min_dist, AA_RAMP), 0.0, 1.0)


def paint_rgb(img: torch.Tensor, coverage: torch.Tensor, color: torch.Tensor) -> torch.Tensor:
    """Alpha-composite a colour onto (..., H, W, 3) float images with (..., H, W)
    coverage; `color` is (..., 3)."""
    cov = coverage[..., None]
    col = color[..., None, None, :]
    # XLA:CPU fuses the first product into the add.
    return fma_f32_exact(*torch.broadcast_tensors(img, 1.0 - cov, col * cov))
