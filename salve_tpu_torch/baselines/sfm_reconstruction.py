"""SfM reconstruction container (parity: salve/baselines/sfm_reconstruction.py).

A copy of salve_tpu/baselines/sfm_reconstruction.py (no JAX).
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np

from salve_tpu_torch.geometry.poses import Pose3


@dataclass
class SfmReconstruction:
    """Camera parameters, camera poses, 3D points and colors."""

    camera: Optional[SimpleNamespace]
    pose_dict: Dict[int, Pose3]
    points: np.ndarray
    rgb: np.ndarray

    @property
    def wTi_list(self) -> List[Optional[Pose3]]:
        """Ordered pose list with None gaps."""
        N = max(self.pose_dict.keys()) + 1
        return [self.pose_dict.get(i, None) for i in range(N)]
