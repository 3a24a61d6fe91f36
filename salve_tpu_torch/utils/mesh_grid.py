"""Regular grid as a point cloud (port of salve_tpu/utils/mesh_grid.py)."""

import numpy as np


def get_mesh_grid_as_point_cloud(
    min_x: int, max_x: int, min_y: int, max_y: int, downsample_factor: float = 1.0
) -> np.ndarray:
    """(N,2) array of (x, y) coordinates of a regular grid."""
    nx = max_x - min_x
    ny = max_y - min_y
    x = np.linspace(min_x, max_x, int((nx + 1) / downsample_factor))
    y = np.linspace(min_y, max_y, int((ny + 1) / downsample_factor))
    x_grid, y_grid = np.meshgrid(x, y)
    return np.hstack([x_grid.flatten()[:, np.newaxis], y_grid.flatten()[:, np.newaxis]])
