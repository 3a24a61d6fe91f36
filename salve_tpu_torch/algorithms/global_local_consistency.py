"""Global/local rotation-consistency filtering.

Parity: salve/algorithms/global_local_consistency.py — estimate global
rotations by averaging, re-synthesize each edge's relative rotation from
the globals, and drop edges deviating more than 5 degrees (the Theia
FilterViewPairsFromOrientation recipe).

A copy of salve_tpu/algorithms/global_local_consistency.py (no JAX).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from salve_tpu_torch.algorithms import rotation_averaging
from salve_tpu_torch.geometry.rotations import rotmat2theta_deg, wrap_angle_deg
from salve_tpu_torch.geometry.sim2 import Sim2

MAX_ALLOWED_DEVIATION_DEG = 5.0


def convert_to_i2Ri1_dict(
    i2Si1_dict: Dict[Tuple[int, int], Sim2]
) -> Dict[Tuple[int, int], np.ndarray]:
    return {e: S.rotation for e, S in i2Si1_dict.items()}


def filter_measurements_to_absolute_rotations(
    wRi_list: List[Optional[np.ndarray]],
    i2Ri1_dict: Dict[Tuple[int, int], np.ndarray],
    max_allowed_deviation_deg: float = MAX_ALLOWED_DEVIATION_DEG,
    verbose: bool = False,
    two_view_reports_dict=None,
    visualize: bool = False,
) -> Dict[Tuple[int, int], np.ndarray]:
    """Keep edges whose measured relative rotation matches the synthesized
    one (from global rotations) within the threshold."""
    kept: Dict[Tuple[int, int], np.ndarray] = {}
    for (i1, i2), i2Ri1 in i2Ri1_dict.items():
        if wRi_list[i1] is None or wRi_list[i2] is None:
            continue
        i2Ri1_synth = wRi_list[i2].T @ wRi_list[i1]
        deviation = wrap_angle_deg(
            rotmat2theta_deg(i2Ri1_synth), rotmat2theta_deg(i2Ri1)
        )
        if deviation < max_allowed_deviation_deg:
            kept[(i1, i2)] = i2Ri1
    return kept


def compute_edge_consistency_fraction(
    wSi_list: List[Optional[Sim2]],
    i2Si1_dict: Dict[Tuple[int, int], Sim2],
    max_allowed_deviation_deg: float,
    two_view_reports_dict=None,
) -> float:
    """Fraction of edges rotation-consistent with the estimated globals."""
    wRi_list = [wSi.rotation if wSi is not None else None for wSi in wSi_list]
    kept = filter_measurements_to_absolute_rotations(
        wRi_list, convert_to_i2Ri1_dict(i2Si1_dict), max_allowed_deviation_deg
    )
    return len(kept) / len(i2Si1_dict) if i2Si1_dict else 0.0


def filter_measurements_by_global_local_consistency(
    i2Si1_dict: Dict[Tuple[int, int], Sim2],
    two_view_reports_dict=None,
    max_allowed_deviation_deg: float = MAX_ALLOWED_DEVIATION_DEG,
) -> Dict[Tuple[int, int], Sim2]:
    """Average rotations globally, then drop locally-inconsistent edges."""
    wRi_list = rotation_averaging.globalaveraging2d(convert_to_i2Ri1_dict(i2Si1_dict))
    if wRi_list is None:
        return i2Si1_dict
    kept = filter_measurements_to_absolute_rotations(
        wRi_list, convert_to_i2Ri1_dict(i2Si1_dict), max_allowed_deviation_deg
    )
    return {e: i2Si1_dict[e] for e in kept}
