"""IoU utilities (parity: salve/utils/iou_utils.py, torch-free).

A copy of salve_tpu/utils/iou_utils.py (no JAX).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def texture_map_iou(f1: np.ndarray, f2: np.ndarray) -> float:
    """IoU of the nonzero-occupancy masks of two (H,W,C) texture maps."""
    return binary_mask_iou(np.amax(f1, axis=2) > 0, np.amax(f2, axis=2) > 0)


def binary_mask_iou(mask1: np.ndarray, mask2: np.ndarray) -> float:
    """IoU between two binary masks."""
    eps = 1e-12
    inter = np.logical_and(mask1, mask2)
    union = np.logical_or(mask1, mask2)
    return float(inter.sum() / (union.sum() + eps))


def intersectionAndUnion(
    output: np.ndarray, target: np.ndarray, K: int, ignore_index: int = 255
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-class intersection/union/target histogram counts."""
    assert output.shape == target.shape
    output = output.reshape(-1).copy()
    target = target.reshape(-1)
    output[target == ignore_index] = 255
    intersection = output[output == target]
    area_intersection, _ = np.histogram(intersection, bins=np.arange(K + 1))
    area_output, _ = np.histogram(output, bins=np.arange(K + 1))
    area_target, _ = np.histogram(target, bins=np.arange(K + 1))
    area_union = area_output + area_target - area_intersection
    return area_intersection, area_union, area_target
