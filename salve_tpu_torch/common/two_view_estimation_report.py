"""Per-edge relative-pose error record (parity: salve/common/two_view_estimation_report.py:9).

A copy of salve_tpu/common/two_view_estimation_report.py (no JAX).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class TwoViewEstimationReport:
    """Errors w.r.t. GT for one pano-pano edge.

    Attributes:
        gt_class: ground-truth class of the edge (1 = genuine alignment).
        R_error_deg: relative rotation error (degrees).
        U_error_deg: relative translation error (the reference's naming; a
            Euclidean translation error despite the angular-sounding name).
        confidence: verifier confidence for the chosen hypothesis.
    """

    gt_class: int
    R_error_deg: Optional[float] = None
    U_error_deg: Optional[float] = None
    confidence: Optional[float] = None
