"""Global 2D rotation averaging.

Parity: salve/algorithms/rotation_averaging.py, which wraps GTSAM's
ShonanAveraging2 (C++ SDP-staircase over BetweenFactorPose2s). For SO(2)
the chordal-cost problem has a classical spectral relaxation: build the
Hermitian matrix H with H[i,j] = exp(i*theta_ij) and take the phase of the
leading eigenvector — followed by a few Gauss-Newton sweeps on the wrapped
angle residuals to land exactly on the local optimum of the original cost.
For connected graphs at the noise levels Shonan itself converges under
(<~63 deg, per the reference's own note), the spectral+GN solution matches
the Shonan optimum. Everything is one eigendecomposition + dense solves.

A copy of salve_tpu/algorithms/rotation_averaging.py (no JAX).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from salve_tpu_torch.geometry.rotations import rotmat2d, rotmat2theta_deg

GN_ITERS = 20


def _solve_angles(
    edges: np.ndarray, theta_ij: np.ndarray, num_nodes: int
) -> np.ndarray:
    """Spectral init + GN refinement for angles theta_i with measurements
    theta_ij ~ theta_i - theta_j  (for edge (j, i), i.e. i2Ri1 = R(i2)^-1 R(i1))."""
    # Hermitian measurement matrix.
    H = np.zeros((num_nodes, num_nodes), dtype=np.complex128)
    for (i1, i2), th in zip(edges, theta_ij):
        # i2Ri1 = R_w_i2^T R_w_i1 -> theta_i1 - theta_i2 = th
        z = np.exp(1j * th)
        H[i1, i2] += z  # H[i1,i2] ~ exp(i(theta_i1 - theta_i2))
        H[i2, i1] += np.conj(z)
    np.fill_diagonal(H, 1.0)

    w, V = np.linalg.eigh(H)
    v = V[:, -1]
    angles = np.angle(v)
    angles = angles - angles[0]

    # Gauss-Newton on f = sum wrap(theta_i1 - theta_i2 - th)^2, gauge-fixed at node 0.
    for _ in range(GN_ITERS):
        r = np.array(
            [
                _wrap(angles[i1] - angles[i2] - th)
                for (i1, i2), th in zip(edges, theta_ij)
            ]
        )
        J = np.zeros((len(edges), num_nodes))
        for k, (i1, i2) in enumerate(edges):
            J[k, i1] += 1.0
            J[k, i2] -= 1.0
        # Gauge fix: drop node 0's column.
        Jf = J[:, 1:]
        delta, *_ = np.linalg.lstsq(Jf, -r, rcond=None)
        if np.max(np.abs(delta)) < 1e-12:
            break
        angles[1:] += delta
    return angles


def _wrap(theta):
    return np.arctan2(np.sin(theta), np.cos(theta))


def globalaveraging2d(
    i2Ri1_dict: Dict[Tuple[int, int], Optional[np.ndarray]]
) -> Optional[List[Optional[np.ndarray]]]:
    """Global rotations wRi from relative rotations (parity :68).

    Works on arbitrary (non-contiguous) pano IDs; nodes outside the
    measurement graph get None.
    """
    edges_keys = [k for k, v in i2Ri1_dict.items() if v is not None]
    if not edges_keys:
        return None

    num_images = max(max(i1, i2) for i1, i2 in edges_keys) + 1
    connected_nodes = sorted({i for e in edges_keys for i in e})
    remap = {i: k for k, i in enumerate(connected_nodes)}

    edges = np.array([[remap[i1], remap[i2]] for (i1, i2) in edges_keys])
    theta_ij = np.array(
        [np.radians(rotmat2theta_deg(i2Ri1_dict[e])) for e in edges_keys]
    )

    angles = _solve_angles(edges, theta_ij, len(connected_nodes))

    wRi_list: List[Optional[np.ndarray]] = [None] * num_images
    for original_i, k in remap.items():
        wRi_list[original_i] = rotmat2d(np.degrees(angles[k]))
    return wRi_list
