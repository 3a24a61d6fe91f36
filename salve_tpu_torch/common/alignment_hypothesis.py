"""Relative-pose hypothesis record produced by Stage A (W/D/O alignment);
a copy of salve_tpu/common/alignment_hypothesis.py."""

from __future__ import annotations

from typing import List, NamedTuple

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


def prune_to_unique_sim2_objs(
    possible_alignment_info: List[AlignmentHypothesis],
) -> List[AlignmentHypothesis]:
    """Drop hypotheses whose Sim(2) duplicates an earlier one (order-preserving)."""
    pruned: List[AlignmentHypothesis] = []
    for hypothesis in possible_alignment_info:
        if not any(hypothesis.i2Ti1 == kept.i2Ti1 for kept in pruned):
            pruned.append(hypothesis)
    return pruned
