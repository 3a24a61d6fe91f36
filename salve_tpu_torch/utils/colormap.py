"""Tango color palette (parity: salve/utils/colormap.py).

A copy of salve_tpu/utils/colormap.py (no JAX).
"""

import numpy as np


def get_tango_colormap(rgb: bool = True) -> np.ndarray:
    """(N,3) uint8 palette of visually distinctive colors (Tango-based)."""
    color_list = np.array(
        [
            [252, 233, 79], [196, 160, 0], [252, 175, 62], [206, 92, 0],
            [233, 185, 110], [193, 125, 17], [143, 89, 2], [138, 226, 52],
            [78, 154, 6], [114, 159, 207], [32, 74, 135], [173, 127, 168],
            [92, 53, 102], [239, 41, 41], [164, 0, 0], [136, 138, 133],
            [85, 87, 83], [46, 52, 54],
        ],
        dtype=np.uint8,
    )
    if not rgb:
        color_list = color_list[:, ::-1]
    return color_list


def get_redgreen_colormap(N: int) -> np.ndarray:
    """(N,3) uint8 colormap from red to green (parity: colormap.py:57).

    The reference interpolates hue with the `colour` package (red 0 deg ->
    green 120 deg through yellow at full saturation, half lightness); the
    same HSL ramp is computed here directly.
    """
    if N < 1:
        return np.zeros((0, 3), dtype=np.uint8)
    hues = np.linspace(0.0, 1.0 / 3.0, N)  # 0=red .. 1/3=green

    def hsl_to_rgb(h: float) -> np.ndarray:
        # s=1, l=0.5 -> c=1, m=0.
        hp = h * 6.0
        x = 1.0 - abs(hp % 2.0 - 1.0)
        if hp < 1:
            r, g, b = 1.0, x, 0.0
        elif hp < 2:
            r, g, b = x, 1.0, 0.0
        else:  # hp <= 2.0 for hue <= 1/3
            r, g, b = 0.0, 1.0, x
        return np.array([r, g, b])

    return (np.stack([hsl_to_rgb(h) for h in hues]) * 255).astype(np.uint8)
