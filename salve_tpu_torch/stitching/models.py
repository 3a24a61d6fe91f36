"""Lightweight location/feature records (parity: salve/stitching/models/).

A copy of salve_tpu/stitching/models.py (no JAX).
"""

from __future__ import annotations

import math


class Point2d:
    """2D point (parity: stitching/models/locations.py:10)."""

    __slots__ = ("x", "y")

    def __init__(self, x: float, y: float) -> None:
        self.x = x
        self.y = y

    def distance(self, other: "Point2d") -> float:
        if not isinstance(other, Point2d):
            raise ValueError("Both arguments to `distance()` must be Point2d objects.")
        return math.sqrt((self.x - other.x) ** 2 + (self.y - other.y) ** 2)

    def __repr__(self) -> str:
        return f"Point2d({self.x:.4f}, {self.y:.4f})"


class Point3d:
    __slots__ = ("x", "y", "z")

    def __init__(self, x: float, y: float, z: float) -> None:
        self.x = x
        self.y = y
        self.z = z


class Pose:
    """2D pose: position + clockwise rotation in degrees."""

    __slots__ = ("position", "rotation")

    def __init__(self, position: Point2d, rotation: float) -> None:
        self.position = position
        self.rotation = rotation


ORIGIN_POSE = Pose(position=Point2d(x=0, y=0), rotation=0)


class Feature2dU:
    """W/D/O boundary feature known only by its pano u-coordinate."""

    def __init__(self, u: float, feature_type: str) -> None:
        self.u = u
        self.feature_type = feature_type


class Feature2dXy(Feature2dU):
    """W/D/O feature with a known 2D location (after ray casting)."""

    def __init__(self, u: float, feature_type: str, xy: Point2d, depth: float) -> None:
        super().__init__(u, feature_type)
        self.xy = xy
        self.depth = depth

    @staticmethod
    def fromPoint2d(coord: Point2d, feature_type: str) -> "Feature2dXy":
        from salve_tpu_torch.stitching import transform as T

        return Feature2dXy(
            u=T.xy_to_u(coord), feature_type=feature_type, xy=coord, depth=T.xy_to_depth(coord)
        )

    def _rotate_clockwise(self, rotation_deg: float) -> "Feature2dXy":
        from salve_tpu_torch.stitching import transform as T

        xy_rot = T.rotate_xys_clockwise([self.xy], rotation_deg)[0]
        return Feature2dXy.fromPoint2d(xy_rot, self.feature_type)

    def _translate(self, tx: float, ty: float) -> "Feature2dXy":
        return Feature2dXy.fromPoint2d(
            Point2d(x=self.xy.x + tx, y=self.xy.y + ty), self.feature_type
        )

    def project_to_camera_cartesian_by_camera_pose(self, pose: Pose) -> "Feature2dXy":
        return self._translate(-pose.position.x, -pose.position.y)._rotate_clockwise(
            -pose.rotation
        )

    def apply_camera_pose_to_camera_cartesian(self, pose: Pose) -> "Feature2dXy":
        return self._rotate_clockwise(pose.rotation)._translate(
            pose.position.x, pose.position.y
        )

    def uv(self, height: float):
        from salve_tpu_torch.stitching import transform as T

        return T.xy_to_uv(self.xy, height)
