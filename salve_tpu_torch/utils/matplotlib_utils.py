"""Matplotlib vector-graphics helpers (parity: salve/utils/matplotlib_utils.py).

A copy of salve_tpu/utils/matplotlib_utils.py (no JAX); matplotlib comes
through `utils/plotting.py`.
"""

from typing import Optional

import numpy as np

from salve_tpu_torch.utils import plotting


def draw_polygon_mpl(ax, polygon: np.ndarray, color, linewidth: Optional[float] = None) -> None:
    """Draw a polygon boundary (first point repeated last)."""
    if linewidth is None:
        ax.plot(polygon[:, 0], polygon[:, 1], color=color)
    else:
        ax.plot(polygon[:, 0], polygon[:, 1], color=color, linewidth=linewidth)


def plot_polygon_patch_mpl(
    polygon_pts: np.ndarray, ax, color="y", alpha: float = 0.3, zorder: int = 1
) -> None:
    """Plot a filled polygon patch."""
    mpatches, MPath = plotting.patches("plot_polygon_patch_mpl")

    n, _ = polygon_pts.shape
    codes = np.ones(n, dtype=MPath.code_type) * MPath.LINETO
    codes[0] = MPath.MOVETO
    path = MPath(polygon_pts, codes)
    patch = mpatches.PathPatch(path, facecolor=color, alpha=alpha, zorder=zorder)
    ax.add_patch(patch)


def legend_without_duplicate_labels(ax) -> None:
    """De-duplicated legend entries."""
    handles, labels = ax.get_legend_handles_labels()
    unique = [
        (h, l) for i, (h, l) in enumerate(zip(handles, labels)) if l not in labels[:i]
    ]
    if unique:
        ax.legend(*zip(*unique))
