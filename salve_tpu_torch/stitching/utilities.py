"""W/D/O edge-feature extraction (parity: salve/stitching/utilities.py).

A copy of salve_tpu/stitching/utilities.py (no JAX).
"""

from __future__ import annotations

from typing import Any, Dict, List

from salve_tpu_torch.stitching.constants import WDO_CODE
from salve_tpu_torch.stitching.models import Feature2dU


def get_dwo_edge_feature2ds_from_prediction(
    preds: Dict[str, Any], height: float
) -> List[List[Feature2dU]]:
    """Confident W/D/O detections -> per-object (left, right) u-features."""
    features = []
    for wdo in preds["wdo"][0]:
        wdo_type = WDO_CODE[int(wdo[0]) - 1]
        confidence = wdo[1]
        if confidence > 0.5:
            features.append(
                [
                    Feature2dU(u=wdo[2], feature_type=wdo_type),
                    Feature2dU(u=wdo[4], feature_type=wdo_type),
                ]
            )
    return features
