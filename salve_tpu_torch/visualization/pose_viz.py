"""3D pose-graph visualization (parity: salve/visualization/utils.py:13-107).

The reference renders GT + estimated camera poses as Open3D colormapped
spheres (red->green by capture order; GT radius 0.5, estimate 0.2) with RGB
coordinate-frame axes per camera, in an interactive window. Open3D is a
C++/GUI dependency with no place in a headless TPU pod, so this port draws
the same scene with matplotlib's 3D axes and (by default) saves a PNG — the
form every other diagnostic in this repo takes; pass show=True for the
interactive window when a display exists.

A copy of salve_tpu/visualization/pose_viz.py (no JAX). matplotlib comes
through `utils/plotting.py` inside `plot_3d_poses`, so the modules and CLIs
that import this one start without it; without matplotlib the call raises
`plotting.MatplotlibMissing`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from salve_tpu_torch.geometry.poses import Pose3
from salve_tpu_torch.utils import plotting
from salve_tpu_torch.utils.colormap import get_redgreen_colormap

_AXIS_COLORS = ("r", "g", "b")  # x, y, z (parity: visualization/utils.py:54-57)


def get_colormapped_spheres(
    wTi_list: Sequence[Optional[Pose3]],
) -> Tuple[np.ndarray, np.ndarray]:
    """Sphere centers + red->green colors for valid poses (parity :13-38).

    Returns:
        point_cloud: (N,3) float centers (translations of non-None poses).
        rgb: (N,3) uint8, transitioning red (first capture) -> green (last).
    """
    valid = [wTi for wTi in wTi_list if wTi is not None]
    colormap = get_redgreen_colormap(N=len(valid))
    if not valid:
        return np.zeros((0, 3)), np.zeros((0, 3), dtype=np.uint8)
    point_cloud = np.array([wTi.translation() for wTi in valid])
    return point_cloud, colormap


def coordinate_frame_segments(
    wTc: Pose3, axis_length: float = 1.0
) -> List[np.ndarray]:
    """3 world-frame line segments for a camera's x/y/z axes (parity :41-77).

    Returns a list of three (2,3) arrays [origin, origin + R e_axis * len].
    """
    segments = []
    origin = wTc.translation()
    for axis in range(3):
        end_cam = np.zeros(3)
        end_cam[axis] = axis_length
        end_world = wTc.rotation() @ end_cam + origin
        segments.append(np.stack([origin, end_world]))
    return segments


def plot_3d_poses(
    aTi_list_gt: Sequence[Optional[Pose3]],
    bTi_list_est: Sequence[Optional[Pose3]],
    save_fpath: Optional[str] = None,
    show: bool = False,
    title: str = "",
) -> None:
    """Render GT (large markers) + estimated (small) poses with axes (:80-107).

    Args:
        aTi_list_gt: ground-truth camera poses (None = not localized).
        bTi_list_est: estimated camera poses, same indexing.
        save_fpath: PNG output path (headless default).
        show: open an interactive window instead of / besides saving.
        title: figure title (e.g. "before Sim(3) alignment").
    """
    plt = plotting.pyplot("plot_3d_poses", agg=not show)

    fig = plt.figure(figsize=(10, 10))
    ax = fig.add_subplot(projection="3d")

    for wTi_list, size, label in (
        (bTi_list_est, 40, "estimated"),
        (aTi_list_gt, 160, "ground truth"),
    ):
        pts, rgb = get_colormapped_spheres(wTi_list)
        if len(pts):
            ax.scatter(
                pts[:, 0], pts[:, 1], pts[:, 2],
                c=rgb / 255.0, s=size, label=label,
                edgecolors="k" if size > 100 else "none", depthshade=False,
            )
        for wTi in wTi_list:
            if wTi is None:
                continue
            for seg, color in zip(coordinate_frame_segments(wTi), _AXIS_COLORS):
                ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], c=color, linewidth=0.8)

    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    if title:
        ax.set_title(title)
    ax.legend(loc="upper right")
    if save_fpath is not None:
        fig.savefig(save_fpath, dpi=120, bbox_inches="tight")
    if show:
        plt.show()
    plt.close(fig)
