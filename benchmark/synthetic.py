"""Inputs made from the seed: synthetic panos and a verifier corpus.

`pano_pool` is the benchmark's own copy of the port's synthetic pano
generator (salve_tpu_torch/dataset/synthetic_bank.py, itself a copy of
bench.py's), drawn for all panos at once: depth rays below the horizon hit
a floor plane, above it a ceiling plane, else walls at random distances;
colours are uniform noise in [0, 1].

`corpus_chunk` makes rows of a training corpus of u8 tuples on the device;
a row's content depends only on the seed and the row, so the reference
can make the rows it needs again.
"""

from __future__ import annotations

import numpy as np
import torch


def pano_pool(num_panos: int, h: int, w: int, seed: int):
    """(P, h, w) uint16 depth in mm and (P, h, w, 3) float32 rgb in [0, 1]."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 11]))
    rgbs = rng.random((num_panos, h, w, 3), dtype=np.float32)
    cam_h = rng.uniform(1.4, 1.7, num_panos)
    ceil_h = rng.uniform(1.0, 1.5, num_panos)
    wall_d = rng.uniform(2.0, 5.0, (num_panos, w))
    phi = ((np.arange(h) + 0.5) / h - 0.5) * np.pi
    sin, cos = np.sin(phi), np.cos(phi)
    with np.errstate(divide="ignore"):
        floor_rho = np.where(sin < -0.05, cam_h[:, None] / np.maximum(-sin, 1e-3)[None], np.inf)
        ceil_rho = np.where(sin > 0.05, ceil_h[:, None] / np.maximum(sin, 1e-3)[None], np.inf)
    wall_rho = wall_d[:, None, :] / np.maximum(cos, 1e-3)[None, :, None]
    rho = np.minimum(np.minimum(floor_rho, ceil_rho)[:, :, None], wall_rho)
    depths = np.clip(rho * 1000, 0, 65535).astype(np.uint16)
    return depths, rgbs


CORPUS_CHUNK = 512  # rows a draw


def corpus_chunk(seed: int, chunk: int, n_rows: int, shape, device) -> torch.Tensor:
    """Rows [chunk * CORPUS_CHUNK, + n_rows) of the corpus: (n_rows, *shape)
    uint8 on `device`, uniform in [0, 255]."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 7_919 + 1 + chunk) % (2**63 - 1))
    return torch.randint(0, 256, (n_rows, *shape), generator=g, device=device, dtype=torch.uint8)


def corpus_labels(seed: int, n: int) -> np.ndarray:
    """Half the labels positive, in an order drawn from the seed."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 13]))
    return rng.permutation(np.arange(n) % 2).astype(np.int32)
