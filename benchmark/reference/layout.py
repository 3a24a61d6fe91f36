"""Plain float32 rasters of room layouts: the verifier's layout modality.

Written from SALVe's layout renderer (salve/utils/bev_rendering_utils.py:
rasterize_room_layout_pair, cv2's fillPoly and line at LINE_AA): a room is
drawn white, each W/D/O over it as a thick anti-aliased line (windows red,
doors green, openings blue) in list order, and the image is flipped
vertically. Pano 1's layout is first moved into pano 2's frame by the
hypothesis's Sim(2), in float64.

* World to image: a point p in metres lies at (1.5 p + half) / mpp pixels,
  half = int(img_px / 2 * mpp) metres; pixel centres are whole numbers.
* The room: the even-odd rule, a pixel inside where an odd number of the
  ring's edges crosses its row to its right: edge (a, b) with
  (a_y > y) != (b_y > y) and x < a_x + (y - a_y)(b_x - a_x) / (b_y - a_y).
* A W/D/O: the distance d from the pixel to the segment, the projection's
  parameter clamped to the segment's ends, and cv2's LINE_AA profile for a
  line of width w: coverage clamp((w / 2 + 0.65 + 1.25 / 2 - d) / 1.25, 0,
  1), 50% at w / 2 + 0.65 px over a 1.25 px band; the colour is painted over
  what is there by the coverage.
* round to the nearest level, clamp to [0, 255], u8.

Departures from the program's rasters (salve_tpu_torch/rendering/layout.py,
ops/raster.py), none of which a pixel may depend on beyond a rounding tie:
every float32 operation here is rounded on its own, where the program
repeats XLA:CPU's fused multiply-adds (the world-to-image map, the dot
products, the segment's closest point and the paint); the divisions by mpp
and by the ramp are IEEE divisions, where the program multiplies by float32
reciprocals; the rotation comes from the angle in float64 here and from the
port's Sim(2) there. `precision="bf16"` is the control: every vertex and
endpoint rounded to bfloat16 before it is drawn.

Nothing here imports the program.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

HOHONET_TO_ZIND_SCALE = 1.5
AA_PAD = 0.65
AA_RAMP = 1.25
COLORS = {"windows": (255.0, 0.0, 0.0), "doors": (0.0, 255.0, 0.0), "openings": (0.0, 0.0, 255.0)}
EDGE_CHUNK = 128


def moved(layout, theta_deg: float, t) -> Tuple[np.ndarray, list]:
    """`layout` ((V, 2) room, [(type, pt1, pt2)]) moved by the Sim(2) of
    rotation theta and translation t (scale 1): p -> R p + t in float64."""
    th = np.deg2rad(float(theta_deg))
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    t = np.asarray(t, dtype=np.float64)
    move = lambda p: np.asarray(p, dtype=np.float64) @ R.T + t  # noqa: E731
    return move(layout[0]), [(kind, tuple(move(a)), tuple(move(b))) for kind, a, b in layout[1]]


def _to_image(p: torch.Tensor, img_px: int, mpp: float) -> torch.Tensor:
    half = float(int((img_px / 2) * mpp))
    return (p * HOHONET_TO_ZIND_SCALE + half) / mpp


def _inside(ring: torch.Tensor, side: int) -> torch.Tensor:
    """(side, side) bool: the even-odd rule over the (V, 2) image-space ring."""
    dev = ring.device
    if ring.shape[0] == 0:
        return torch.zeros((side, side), dtype=torch.bool, device=dev)
    a, b = ring, torch.roll(ring, -1, dims=0)
    ys = torch.arange(side, dtype=torch.float32, device=dev)[:, None]  # rows
    xs = torch.arange(side, dtype=torch.float32, device=dev)[:, None, None]  # columns
    crosses = (a[:, 1] > ys) != (b[:, 1] > ys)  # (rows, V)
    dy = b[:, 1] - a[:, 1]
    x_at = a[:, 0] + (ys - a[:, 1]) * (b[:, 0] - a[:, 0]) / torch.where(dy == 0, torch.ones_like(dy), dy)
    count = torch.zeros((side, side), dtype=torch.int32, device=dev)  # (rows, columns)
    for e0 in range(0, ring.shape[0], EDGE_CHUNK):
        sl = slice(e0, e0 + EDGE_CHUNK)
        hit = crosses[None, :, sl] & (xs < x_at[None, :, sl])  # (columns, rows, edges)
        count += hit.sum(dim=-1, dtype=torch.int32).T
    return count % 2 == 1


def _coverage(a: torch.Tensor, b: torch.Tensor, width_px: float, side: int) -> torch.Tensor:
    """(side, side) coverage of the segment a-b (image space) drawn w px wide."""
    dev = a.device
    ys = torch.arange(side, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(side, dtype=torch.float32, device=dev)[None, :]
    ab = b - a
    s = ((xs - a[0]) * ab[0] + (ys - a[1]) * ab[1]) / torch.clamp(ab[0] * ab[0] + ab[1] * ab[1], min=1e-12)
    s = torch.clamp(s, 0.0, 1.0)
    d = torch.sqrt((xs - (a[0] + s * ab[0])) ** 2 + (ys - (a[1] + s * ab[1])) ** 2)
    top = width_px / 2.0 + AA_PAD + AA_RAMP / 2.0
    return torch.clamp((top - d) / AA_RAMP, 0.0, 1.0)


def raster(layout, img_px: int, mpp: float, width_px: float, device, precision: str = "fp32") -> torch.Tensor:
    """(img_px + 1, img_px + 1, 3) u8 raster of one layout on `device`."""
    side = img_px + 1
    dev = torch.device(device)

    def points(p) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(p, dtype=np.float64).reshape(-1, 2), device=dev).to(torch.float32)
        if precision == "bf16":
            x = x.to(torch.bfloat16).to(torch.float32)
        return _to_image(x, img_px, mpp)

    img = torch.where(_inside(points(layout[0]), side)[..., None], 255.0, 0.0).expand(side, side, 3)
    for kind, p1, p2 in layout[1]:
        ends = points([p1, p2])
        cov = _coverage(ends[0], ends[1], width_px, side)[..., None]
        img = img * (1.0 - cov) + torch.tensor(COLORS[kind], device=dev) * cov
    return torch.clamp(torch.round(torch.flip(img, dims=[0])), 0, 255).to(torch.uint8)


@torch.no_grad()
def rasters(layouts: Sequence, img_px: int, mpp: float, width_px: float, device,
            precision: str = "fp32") -> torch.Tensor:
    """(N, img_px + 1, img_px + 1, 3) u8 rasters of N layouts."""
    side = img_px + 1
    if not layouts:
        return torch.zeros((0, side, side, 3), dtype=torch.uint8, device=torch.device(device))
    return torch.stack([raster(x, img_px, mpp, width_px, device, precision) for x in layouts])


def pair_rasters(layouts: List, pairs: np.ndarray, theta_deg: np.ndarray, t: np.ndarray, img_px: int, mpp: float,
                 width_px: float, device, precision: str = "fp32") -> Tuple[torch.Tensor, torch.Tensor]:
    """Each hypothesis's pano 1 layout in pano 2's frame, (H, side, side, 3),
    and every pano's own, (P, side, side, 3), the floor's layouts `layouts`
    a pano."""
    ones = [moved(layouts[i1], th, tt) for (i1, _), th, tt in zip(pairs, theta_deg, t)]
    return (rasters(ones, img_px, mpp, width_px, device, precision),
            rasters(layouts, img_px, mpp, width_px, device, precision))
