"""Top-down canvas rendering of shapes/cameras (parity: salve/stitching/draw.py).

A copy of salve_tpu/stitching/draw.py (no JAX) without the two functions
that make matplotlib figures (`draw_all_room_shapes_with_given_poses_and_shapes`,
`draw_all_room_shapes_with_poses`, salve_tpu/stitching/draw.py:80-145): the
card's machine has no matplotlib, and they wait for the renders of ROADMAP
item 14. The helpers below take an axis the caller made and import nothing
of matplotlib.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from salve_tpu_torch.stitching.models import Point2d, Pose
from salve_tpu_torch.stitching import transform as transform_utils

TANGO_COLOR_PALETTE = [
    [252, 233, 79], [237, 212, 0], [196, 160, 0], [252, 175, 62],
    [245, 121, 0], [206, 92, 0], [233, 185, 110], [193, 125, 17],
    [143, 89, 2], [138, 226, 52], [115, 210, 22], [78, 154, 6],
    [114, 159, 207], [52, 101, 164], [32, 74, 135], [173, 127, 168],
    [117, 80, 123], [92, 53, 102], [239, 41, 41], [204, 0, 0],
    [164, 0, 0], [136, 138, 133], [85, 87, 83], [46, 52, 54],
]


def _to_global(shape: List[Point2d], pose: Optional[Pose]) -> np.ndarray:
    if pose is not None:
        shape = [transform_utils.transform_xy_by_pose(p, pose) for p in shape]
    return np.array([[p.x, p.y] for p in shape])


def draw_shape_in_top_down_canvas(
    axis, shape: List[Point2d], color: str, pose: Optional[Pose] = None
) -> None:
    """Draw a boundary polyline (closed) on a matplotlib axis."""
    arr = _to_global(shape, pose)
    arr = np.vstack([arr, arr[:1]])
    axis.plot(arr[:, 0], arr[:, 1], color=color, linewidth=1)


def draw_shape_in_top_down_canvas_fill(
    axis, shape: List[Point2d], color, pose: Optional[Pose] = None
) -> None:
    """Draw a filled room shape on a matplotlib axis."""
    arr = _to_global(shape, pose)
    axis.fill(arr[:, 0], arr[:, 1], color=color, alpha=0.6)


def draw_camera_in_top_down_canvas(axis, pose: Pose, color: str, size: int = 20) -> None:
    axis.scatter(pose.position.x, pose.position.y, s=size, color=color, marker="o")


def draw_dwo_xy_top_down_canvas(
    axis, fig, filename: Optional[str], dwos_cluster_all
) -> None:
    """Draw every pano's global-frame W/D/O segments, colored by type.

    Parity: salve/stitching/draw.py:57. `dwos_cluster_all` maps pano id ->
    list of (Point2d, Point2d, type) triples with type in
    {"door", "window", "opening"}.
    """
    colors = {"door": "red", "window": "blue", "opening": "green"}
    for _panoid, dwos in dwos_cluster_all.items():
        for dwo in dwos:
            axis.plot(
                [dwo[0].x, dwo[1].x],
                [dwo[0].y, dwo[1].y],
                color=colors[dwo[2]],
                linewidth=0.8,
            )
    axis.set_aspect("equal")
    if filename and fig is not None:
        fig.savefig(filename, dpi=300)


def draw_dwo_in_top_down_canvas(
    axis, xy_from: Point2d, xy_to: Point2d, color: str, pose: Optional[Pose] = None
) -> None:
    pts = [xy_from, xy_to]
    arr = _to_global(pts, pose)
    axis.plot(arr[:, 0], arr[:, 1], color=color, linewidth=3)
