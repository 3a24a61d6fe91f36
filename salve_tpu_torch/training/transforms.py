"""Eval-time preprocessing (the eval half of salve_tpu/training/transforms.py).

Batches are (B, N, H, W, 3) float32 in [0, 255], the JAX package's layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from salve_tpu_torch.ops.numerics import div_const

# ImageNet mean/std in [0, 255] scale (salve/utils/normalization_utils.py:13).
IMAGENET_MEAN = (0.485 * 255, 0.456 * 255, 0.406 * 255)
IMAGENET_STD = (0.229 * 255, 0.224 * 255, 0.225 * 255)


def resize_batch(imgs: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of a (B, N, H, W, 3) batch.

    jax.image.resize(method="linear") antialiases when it downsamples, so
    this uses `antialias=True`.
    """
    b, n, h, w, c = imgs.shape
    x = imgs.reshape(b * n, h, w, c).permute(0, 3, 1, 2).to(torch.float32)
    x = F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1).reshape(b, n, out_h, out_w, c)


def normalize_batch(imgs: torch.Tensor) -> torch.Tensor:
    """ImageNet normalization of [0, 255] inputs."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=imgs.device)
    return div_const(imgs - mean, IMAGENET_STD)


def preprocess_eval(imgs: torch.Tensor, crop_h: int, crop_w: int) -> torch.Tensor:
    """Deterministic center crop + normalize (salve/train_utils.py:126-160)."""
    imgs = imgs.to(torch.float32)
    h, w = imgs.shape[2:4]
    off_h = (h - crop_h) // 2
    off_w = (w - crop_w) // 2
    imgs = imgs[:, :, off_h : off_h + crop_h, off_w : off_w + crop_w]
    return normalize_batch(imgs)
