"""Top-down canvas rendering of shapes/cameras (parity: salve/stitching/draw.py).

A copy of salve_tpu/stitching/draw.py (no JAX). The canvas helpers take an
axis the caller made; the two functions that make a figure when given no
axis take matplotlib through `utils/plotting.py`.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from salve_tpu_torch.stitching.models import Point2d, Pose
from salve_tpu_torch.stitching import transform as transform_utils
from salve_tpu_torch.utils import plotting

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


def draw_all_room_shapes_with_given_poses_and_shapes(
    filename: Optional[str],
    predictions,
    poses,
    groups: List[List],
    confidences=None,
    axis=None,
):
    """Draw every group's refined shapes + cameras on one canvas.

    Parity: salve/stitching/draw.py:169 (schematics/shapely-free redesign:
    `predictions` maps pano id -> List[Point2d] boundary in local frame,
    `poses` maps pano id -> Pose). Returns (axis, fig).
    """
    plt = plotting.pyplot("draw_all_room_shapes_with_given_poses_and_shapes", agg=False)

    fig = None
    if axis is None:
        fig = plt.figure()
        axis = fig.add_subplot(1, 1, 1)
    for i_group, group in enumerate(groups):
        i_color = (i_group % 8) * 3 + i_group // 8
        _color = TANGO_COLOR_PALETTE[i_color % 24]  # group hue (parity)
        for panoid in group:
            shape = list(predictions[panoid])
            shape.append(shape[0])
            draw_shape_in_top_down_canvas(
                axis, shape, color="black", pose=poses[panoid]
            )
            draw_camera_in_top_down_canvas(axis, poses[panoid], "blue", size=20)
    axis.set_aspect("equal")
    if filename and fig is not None:
        fig.savefig(filename)
    return axis, fig


def draw_all_room_shapes_with_poses(
    filename: Optional[str],
    shapes,
    poses,
    axis=None,
) -> List[np.ndarray]:
    """Draw room shapes at given global poses; return global-frame polygons.

    Parity: salve/stitching/draw.py:218. The reference returns a Shapely
    cascaded union; GEOS-free here, the per-room global polygons are
    returned instead (callers needing occupancy take the raster union via
    common/floor_reconstruction_report.py).
    """
    plt = plotting.pyplot("draw_all_room_shapes_with_poses", agg=False)

    fig = None
    if axis is None:
        fig = plt.figure()
        axis = fig.add_subplot(1, 1, 1)
    global_polys: List[np.ndarray] = []
    for panoid, shape in shapes.items():
        pose = poses[panoid]
        global_polys.append(_to_global(list(shape), pose))
        closed = list(shape) + [shape[0]]
        draw_shape_in_top_down_canvas(axis, closed, "black", pose=pose)
        draw_camera_in_top_down_canvas(axis, pose, "black", size=10)
    axis.set_aspect("equal")
    if filename and fig is not None:
        fig.savefig(filename)
    return global_polys
