"""Synthetic indoor pano bank (a copy of the generator at bench.py:22).

Depth rays below the horizon hit a floor plane, above it a ceiling plane,
else walls at random distances; colours are uniform noise in [0, 1].
"""

from __future__ import annotations

import numpy as np


def make_synthetic_pano_bank(num_panos: int, h: int = 512, w: int = 1024, seed: int = 0):
    """(P, h, w) uint16 depth in mm and (P, h, w, 3) float32 rgb in [0, 1]."""
    rng = np.random.default_rng(seed)
    depths = np.zeros((num_panos, h, w), dtype=np.uint16)
    rgbs = rng.uniform(0, 1, (num_panos, h, w, 3)).astype(np.float32)
    v = (np.arange(h) + 0.5) / h - 0.5
    phi = v * np.pi
    for p in range(num_panos):
        cam_h = rng.uniform(1.4, 1.7)
        ceil_h = rng.uniform(1.0, 1.5)
        wall_d = rng.uniform(2.0, 5.0, w)
        with np.errstate(divide="ignore"):
            floor_rho = np.where(np.sin(phi) < -0.05, cam_h / np.maximum(-np.sin(phi), 1e-3), np.inf)
            ceil_rho = np.where(np.sin(phi) > 0.05, ceil_h / np.maximum(np.sin(phi), 1e-3), np.inf)
        wall_rho = wall_d[None, :] / np.maximum(np.cos(phi)[:, None], 1e-3)
        rho = np.minimum(np.minimum(floor_rho[:, None], ceil_rho[:, None]), wall_rho)
        depths[p] = np.clip(rho * 1000, 0, 65535).astype(np.uint16)
    return depths, rgbs
