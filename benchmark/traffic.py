"""The traffic generator of floors: reads a mix's parameters and makes its work.

A mix is a JSON file under `traffic/`, found by its name; its `driver`
names the module under `drivers/` that runs it. The mixes of the
`fused_scoring` driver are made here:

* a closed loop of one client scoring one floor after another.
  Each floor has P panos, a contiguous run of a pool of synthetic panos at
  a drawn offset, and `hypotheses_per_pair` hypotheses for every pano pair
  (i1 < i2), each a Sim(2) with theta uniform in `theta_deg`, both
  translation components uniform in `t_m`, and scale 1. P takes every
  value of `panos_per_floor` (inclusive) once in each block of floors, in
  an order drawn from the seed: every seed gets the same sizes.

The `verifier_training` driver's mixes need nothing generated beyond their
corpus (synthetic.py).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np


class Floor(NamedTuple):
    offset: int  # first pano of the floor in the pool
    n_panos: int
    pairs: np.ndarray  # (H, 2) int: the (i1, i2) floor rows of each hypothesis
    theta_deg: np.ndarray  # (H,)
    t: np.ndarray  # (H, 2)

    @property
    def n_hypotheses(self) -> int:
        return len(self.pairs)


def floor_sizes(mix: Dict, seed: int, n_floors: int) -> List[int]:
    lo, hi = mix["panos_per_floor"]
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 21]))
    sizes: List[int] = []
    while len(sizes) < n_floors:
        sizes += [int(p) for p in rng.permutation(np.arange(lo, hi + 1))]
    return sizes[:n_floors]


def make_floor(mix: Dict, n_panos: int, rng: np.random.Generator) -> Floor:
    i1, i2 = np.triu_indices(n_panos, k=1)
    k = mix["hypotheses_per_pair"]
    pairs = np.stack([np.repeat(i1, k), np.repeat(i2, k)], axis=1)
    h = len(pairs)
    return Floor(
        offset=int(rng.integers(0, mix["pool_panos"] - n_panos + 1)),
        n_panos=n_panos,
        pairs=pairs,
        theta_deg=rng.uniform(*mix["theta_deg"], h),
        t=rng.uniform(*mix["t_m"], (h, 2)),
    )


def floors(mix: Dict, seed: int) -> List[Floor]:
    """The mix's sequence of `floors` floors (the window takes them in
    order, from the start again if it outlasts them)."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 22]))
    return [make_floor(mix, p, rng) for p in floor_sizes(mix, seed, mix["floors"])]


def warmup_floor(mix: Dict, seed: int, n_hypotheses: int) -> Floor:
    """A floor of the mix's largest size, drawn apart from the window's,
    with only its first `n_hypotheses` hypotheses: its banks are the
    largest the window builds, and its batches need no more than a full
    one and a padded tail to reach every shape the window scores."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 23]))
    f = make_floor(mix, mix["panos_per_floor"][1], rng)
    return f._replace(pairs=f.pairs[:n_hypotheses], theta_deg=f.theta_deg[:n_hypotheses], t=f.t[:n_hypotheses])
