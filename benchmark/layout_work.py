"""The work of a call that draws layout rasters: the bytes it must move and
the float operations it must do, for the layout stage's roofline share.

Counted from the work itself, so that any kernel that draws the same
rasters is read on the same yardstick:

* bytes: each u8 raster written once, (img_px + 1)^2 x 3, and the inputs
  read once: each real room vertex (two float32), each real W/D/O's two
  endpoints (four float32) and its colour (three float32);
* operations: for each raster, its rows times its real room edges, one
  crossing each (`CROSSING_OPS`: the row's offset from the edge's start,
  its product with the edge's slope, the division by the edge's height,
  the add to its start); for each real W/D/O, the pixels of its line's
  band, the segment's box grown on every side by the line's half width,
  the anti-aliasing pad and half the ramp, clipped to the image, each
  `BAND_OPS` (the distance to the clamped projection and the ramp: 22; the
  paint over three channels: 10).

A scanline fill does at least the crossings and a banded line at least the
band, and every kernel writes the rasters, so neither count is above what
any such kernel must do: the share cannot pass 100% for the right work.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.layout import AA_PAD, AA_RAMP, HOHONET_TO_ZIND_SCALE

CROSSING_OPS = 4
BAND_OPS = 22 + 10


def band_pixels(ends_px: np.ndarray, width_px: float, side: int) -> int:
    """Pixel centres of a side x side image inside the box of the segment
    `ends_px` ((2, 2) image-space endpoints) grown by the line's reach."""
    reach = width_px / 2.0 + AA_PAD + AA_RAMP / 2.0
    lo = np.clip(np.ceil(ends_px.min(axis=0) - reach), 0, side)
    hi = np.clip(np.floor(ends_px.max(axis=0) + reach) + 1, 0, side)
    return int(np.prod(np.maximum(hi - lo, 0)))


def work(verts: np.ndarray, n_verts: np.ndarray, segs: np.ndarray, n_wdos: np.ndarray, img_px: int, mpp: float,
         width_px: float) -> dict:
    """{"bytes", "ops", "rasters"} of one call on N padded layouts: `verts`
    (N, V, 2) and `segs` (N, K, 2, 2) world metres, the real counts
    `n_verts` and `n_wdos` (N,)."""
    side = img_px + 1
    n = len(n_verts)
    half = float(int((img_px / 2) * mpp))
    band = 0
    for r in range(n):
        for k in range(int(n_wdos[r])):
            ends = (np.asarray(segs[r, k], dtype=np.float64) * HOHONET_TO_ZIND_SCALE + half) / mpp
            band += band_pixels(ends, width_px, side)
    real_v, real_w = int(np.sum(n_verts)), int(np.sum(n_wdos))
    return {"bytes": n * side * side * 3 + real_v * 8 + real_w * (16 + 12),
            "ops": side * real_v * CROSSING_OPS + band * BAND_OPS, "rasters": n}
