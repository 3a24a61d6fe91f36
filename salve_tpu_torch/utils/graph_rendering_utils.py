"""Pose-graph topology / multigraph visualization.

Parity: salve/utils/graph_rendering_utils.py — edges drawn between GT pano
positions, colored green/red by GT class or by a red-to-green error
colormap.

A copy of salve_tpu/utils/graph_rendering_utils.py (no JAX); matplotlib
comes through `utils/plotting.py`, and no graph library is needed.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from salve_tpu_torch.utils import plotting


def generate_edge_colors_from_error_magnitudes(
    errors: List[float], max_error: float = 20.0
) -> List[Tuple[float, float, float]]:
    """Map per-edge errors to red (high) .. green (low) colors."""
    colors = []
    for err in errors:
        frac = min(max(err, 0.0) / max_error, 1.0)
        colors.append((frac, 1.0 - frac, 0.0))
    return colors


def draw_graph_topology(
    edges: List[Tuple[int, int]],
    gt_floor_pose_graph,
    two_view_reports_dict: Optional[Dict] = None,
    title: str = "",
    show_plot: bool = False,
    save_fpath: Optional[str] = None,
    color_scheme: str = "by_gt_class",
) -> None:
    """Render the measurement graph over GT pano positions."""
    plt = plotting.pyplot("draw_graph_topology")

    plt.figure(figsize=(8, 8))
    nodes = gt_floor_pose_graph.nodes

    for (i1, i2) in edges:
        if i1 not in nodes or i2 not in nodes:
            continue
        t1 = nodes[i1].global_Sim2_local.translation
        t2 = nodes[i2].global_Sim2_local.translation
        color = "g"
        if two_view_reports_dict is not None and (i1, i2) in two_view_reports_dict:
            report = two_view_reports_dict[(i1, i2)]
            if color_scheme == "by_error_magnitude" and report.R_error_deg is not None:
                color = generate_edge_colors_from_error_magnitudes([report.R_error_deg])[0]
            else:
                color = "g" if report.gt_class == 1 else "r"
        plt.plot([t1[0], t2[0]], [t1[1], t2[1]], color=color, alpha=0.6)

    for i, pano in nodes.items():
        t = pano.global_Sim2_local.translation
        plt.scatter(t[0], t[1], s=12, color="k", zorder=3)
        plt.text(t[0], t[1], str(i), fontsize=7)

    plt.axis("equal")
    plt.title(title)
    if save_fpath is not None:
        os.makedirs(Path(save_fpath).parent, exist_ok=True)
        plt.savefig(save_fpath, dpi=300)
    if show_plot:
        plt.show()
    plt.close("all")


def draw_multigraph(
    measurements: List,
    gt_floor_pose_graph,
    inferred_floor_pose_graph=None,
    use_gt_positions: bool = True,
    confidence_threshold: float = 0.93,
    save_dir: str = "multigraphs",
) -> None:
    """Render every above-threshold measurement as a multigraph edge."""
    plt = plotting.pyplot("draw_multigraph")

    plt.figure(figsize=(8, 8))
    nodes = gt_floor_pose_graph.nodes
    for m in measurements:
        if m.y_hat != 1 or m.prob < confidence_threshold:
            continue
        if m.i1 not in nodes or m.i2 not in nodes:
            continue
        t1 = nodes[m.i1].global_Sim2_local.translation
        t2 = nodes[m.i2].global_Sim2_local.translation
        color = "g" if m.y_true == 1 else "r"
        plt.plot([t1[0], t2[0]], [t1[1], t2[1]], color=color, alpha=0.4)

    for i, pano in nodes.items():
        t = pano.global_Sim2_local.translation
        plt.scatter(t[0], t[1], s=12, color="k", zorder=3)

    plt.axis("equal")
    os.makedirs(save_dir, exist_ok=True)
    fname = f"{gt_floor_pose_graph.building_id}_{gt_floor_pose_graph.floor_id}.jpg"
    plt.savefig(os.path.join(save_dir, fname), dpi=300)
    plt.close("all")
