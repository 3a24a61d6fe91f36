"""ImageNet normalization constants (port of salve_tpu/utils/normalization_utils.py)."""

from typing import Tuple

import numpy as np


def get_imagenet_mean_std() -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    """ImageNet channel mean/std in [0,255] scale."""
    value_scale = 255
    mean = tuple(m * value_scale for m in (0.485, 0.456, 0.406))
    std = tuple(s * value_scale for s in (0.229, 0.224, 0.225))
    return mean, std


def normalize_img(img: np.ndarray, mean, std=None) -> np.ndarray:
    """Normalize an (H,W,3) float image in place-equivalent fashion."""
    img = img.astype(np.float64)
    if std is None:
        return img - np.asarray(mean)
    return (img - np.asarray(mean)) / np.asarray(std)
