"""(i1, i2, alignment object, W/D/O indices) record, parsed from a wdo_pair_uuid.

A copy of salve_tpu/common/edgewdopair.py (no JAX).
"""

from __future__ import annotations

from typing import NamedTuple


class EdgeWDOPair(NamedTuple):
    """Identifies which W/D/O pair generated an edge's alignment hypothesis."""

    i1: int
    i2: int
    alignment_object: str
    i1_wdo_idx: int
    i2_wdo_idx: int

    @classmethod
    def from_wdo_pair_uuid(cls, i1: int, i2: int, wdo_pair_uuid: str) -> "EdgeWDOPair":
        """Parse e.g. "door_0_1" -> (object="door", i1_wdo_idx=0, i2_wdo_idx=1)."""
        parts = wdo_pair_uuid.split("_")
        alignment_object = parts[0]
        if alignment_object not in ("door", "window", "opening"):
            raise ValueError(f"Unknown alignment object in uuid {wdo_pair_uuid}")
        return cls(
            i1=i1,
            i2=i2,
            alignment_object=alignment_object,
            i1_wdo_idx=int(parts[1]),
            i2_wdo_idx=int(parts[2]),
        )
