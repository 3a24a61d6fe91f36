"""Relative-pose hypothesis record produced by Stage A (copy of
salve_tpu/common/alignment_hypothesis.py:AlignmentHypothesis)."""

from __future__ import annotations

from typing import NamedTuple

from salve_tpu_torch.geometry.sim2 import Sim2


class AlignmentHypothesis(NamedTuple):
    """One candidate relative pose between two panoramas.

    Attributes:
        i2Ti1: relative pose hypothesis (frame i1 -> frame i2).
        wdo_alignment_object: "door" | "window" | "opening".
        i1_wdo_idx: W/D/O index within pano i1's list for this object type.
        i2_wdo_idx: W/D/O index within pano i2's list.
        configuration: "identity" | "rotated" (seen from the other side).
    """

    i2Ti1: Sim2
    wdo_alignment_object: str
    i1_wdo_idx: int
    i2_wdo_idx: int
    configuration: str
