"""2D feature tracks via union-find (parity: salve/common/sfm_track.py).

The reference vendored GTSFM's SfmTrack2d built on GTSAM's C++ DSFMapIndexPair;
here track generation delegates to the pure-Python union-find in
salve_tpu_torch.algorithms.data_association, with the same erroneous-track rule
(a landmark may be seen at most once per pano).

A copy of salve_tpu/common/sfm_track.py (no JAX); tracks come from the
port's algorithms/data_association.py.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np


class SfmMeasurement(NamedTuple):
    """2D detection of a landmark in one image."""

    i: int  # camera/pano index
    uv: np.ndarray  # (2,) image/floor coordinates

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, SfmMeasurement):
            return False
        return self.i == other.i and np.allclose(self.uv, other.uv)

    def __ne__(self, other: object) -> bool:
        return not self == other


class SfmTrack2d(NamedTuple):
    """All 2D measurements of one landmark."""

    measurements: List[SfmMeasurement]

    def number_measurements(self) -> int:
        return len(self.measurements)

    def measurement(self, idx: int) -> SfmMeasurement:
        return self.measurements[idx]

    def select_subset(self, idxs: List[int]) -> "SfmTrack2d":
        return SfmTrack2d(measurements=[self.measurements[i] for i in idxs])

    def validate_unique_cameras(self) -> bool:
        """A valid track sees each camera at most once."""
        cams = [m.i for m in self.measurements]
        return len(set(cams)) == len(cams)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, SfmTrack2d):
            return False
        if len(self.measurements) != len(other.measurements):
            return False
        return all(m1 == m2 for m1, m2 in zip(self.measurements, other.measurements))

    def __ne__(self, other: object) -> bool:
        return not self == other

    @staticmethod
    def generate_tracks_from_pairwise_matches(
        matches_dict: Dict[Tuple[int, int], np.ndarray],
        keypoints_list: List[np.ndarray],
    ) -> List["SfmTrack2d"]:
        """Union-find track generation from pairwise keypoint matches.

        Args:
            matches_dict: (i1,i2) -> (M,2) keypoint index pairs.
            keypoints_list: per-camera (K,2) keypoint coordinates.
        """
        from salve_tpu_torch.algorithms.data_association import (
            generate_tracks_from_pairwise_matches as _gen,
        )

        raw_tracks = _gen(matches_dict)
        tracks: List[SfmTrack2d] = []
        for members in raw_tracks:
            measurements = [
                SfmMeasurement(i=i, uv=np.asarray(keypoints_list[i][k]))
                for (i, k) in members
            ]
            tracks.append(SfmTrack2d(measurements=measurements))
        return tracks
