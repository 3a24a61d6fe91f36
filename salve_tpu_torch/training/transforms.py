"""Batched data augmentation and eval preprocessing (port of salve_tpu/training/transforms.py).

Batches are (B, N, H, W, 3), uint8 or float32 in [0, 255], the JAX
package's layout. Train augmentation keeps the reference's order and its
tuple-consistent randomness (salve/utils/transform.py):

  * photometric jitter — per image INDEPENDENTLY (float math);
  * random crop        — SAME offset for every image of a tuple;
  * random h/v flip    — SAME decision for every image of a tuple;
  * normalize          — ImageNet mean/std in [0, 255] scale.

The crop and flips are index ops and run on uint8. Each step is split in
two: `draw_augment_params` draws the crop offsets, flip decisions and
photometric factors from an explicit `torch.Generator`, and
`apply_augment` applies given parameters. The RNG streams of torch and
JAX cannot match, so the tests feed the parameters JAX draws to the apply
half.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from salve_tpu_torch.ops.numerics import constant, div_const

# ImageNet mean/std in [0, 255] scale (salve/utils/normalization_utils.py:13).
IMAGENET_MEAN = (0.485 * 255, 0.456 * 255, 0.406 * 255)
IMAGENET_STD = (0.229 * 255, 0.224 * 255, 0.225 * 255)

# ColorJitter ranges (salve/utils/transform.py:659-663).
BRIGHTNESS_JITTER = 0.5
CONTRAST_JITTER = 0.5
SATURATION_JITTER = 0.5
HUE_JITTER = 0.05


@dataclass
class PhotometricParams:
    """Per-image jitter factors, each (B, N) float32."""

    brightness: torch.Tensor
    contrast: torch.Tensor
    saturation: torch.Tensor
    hue: torch.Tensor


@dataclass
class AugmentParams:
    """One train batch's augmentation: crop offsets (B,) int64, flip
    decisions (B,) bool, and photometric factors when jitter is on."""

    off_h: torch.Tensor
    off_w: torch.Tensor
    do_hflip: torch.Tensor
    do_vflip: torch.Tensor
    photometric: Optional[PhotometricParams] = None

    def to(self, device: torch.device) -> "AugmentParams":
        p = self.photometric
        if p is not None:
            p = PhotometricParams(*(t.to(device, non_blocking=True) for t in
                                    (p.brightness, p.contrast, p.saturation, p.hue)))
        return AugmentParams(*(t.to(device, non_blocking=True) for t in
                               (self.off_h, self.off_w, self.do_hflip, self.do_vflip)), photometric=p)


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
    return div_const(imgs - constant(IMAGENET_MEAN, imgs.device), IMAGENET_STD)


def _uniform(gen: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    return torch.rand(shape, generator=gen, dtype=torch.float32) * (hi - lo) + lo


def draw_photometric_params(gen: torch.Generator, b: int, n: int) -> PhotometricParams:
    """Brightness, contrast, saturation and hue factors for each image."""
    return PhotometricParams(
        brightness=_uniform(gen, (b, n), 1 - BRIGHTNESS_JITTER, 1 + BRIGHTNESS_JITTER),
        contrast=_uniform(gen, (b, n), 1 - CONTRAST_JITTER, 1 + CONTRAST_JITTER),
        saturation=_uniform(gen, (b, n), 1 - SATURATION_JITTER, 1 + SATURATION_JITTER),
        hue=_uniform(gen, (b, n), -HUE_JITTER, HUE_JITTER),
    )


def draw_augment_params(
    gen: torch.Generator, b: int, n: int, h: int, w: int, crop_h: int, crop_w: int, photometric: bool = False
) -> AugmentParams:
    """Crop offsets in [0, h - crop_h] x [0, w - crop_w], fair h/v flips,
    and (with `photometric`) jitter factors, drawn from `gen` (on its device)."""
    return AugmentParams(
        off_h=torch.randint(0, h - crop_h + 1, (b,), generator=gen),
        off_w=torch.randint(0, w - crop_w + 1, (b,), generator=gen),
        do_hflip=torch.rand(b, generator=gen) < 0.5,
        do_vflip=torch.rand(b, generator=gen) < 0.5,
        photometric=draw_photometric_params(gen, b, n) if photometric else None,
    )


def _rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    return 0.299 * img[..., 0:1] + 0.587 * img[..., 1:2] + 0.114 * img[..., 2:3]


def photometric_shift(imgs: torch.Tensor, p: PhotometricParams) -> torch.Tensor:
    """Brightness/contrast/saturation/hue jitter with given factors
    (salve_tpu/training/transforms.py:54); imgs (B, N, H, W, 3) float32 in [0, 255]."""
    def f(t):
        return t.to(imgs.device)[:, :, None, None, None]

    out = imgs * f(p.brightness)
    mean_gray = _rgb_to_gray(out).mean(dim=(2, 3), keepdim=True)
    out = (out - mean_gray) * f(p.contrast) + mean_gray
    gray = _rgb_to_gray(out)
    out = (out - gray) * f(p.saturation) + gray

    # Hue rotation in YIQ space (hue_jitter is tiny: +/-0.05 turns).
    theta = f(p.hue) * 2 * math.pi
    cos_t, sin_t = torch.cos(theta)[..., 0], torch.sin(theta)[..., 0]
    y = _rgb_to_gray(out)[..., 0]
    i = 0.596 * out[..., 0] - 0.274 * out[..., 1] - 0.322 * out[..., 2]
    q = 0.211 * out[..., 0] - 0.523 * out[..., 1] + 0.312 * out[..., 2]
    i, q = cos_t * i - sin_t * q, sin_t * i + cos_t * q
    r = y + 0.956 * i + 0.621 * q
    g = y - 0.272 * i - 0.647 * q
    bch = y - 1.106 * i + 1.703 * q
    return torch.stack([r, g, bch], dim=-1).clamp(0.0, 255.0)


def _crop_batch(imgs: torch.Tensor, off_h: torch.Tensor, off_w: torch.Tensor, crop_h: int, crop_w: int):
    """Crop a (B, N, H, W, 3) batch at per-example offsets: a row window,
    then a column window, each one gather (salve_tpu/training/transforms.py:93)."""
    b, n, h, w, c = imgs.shape
    rows = off_h.to(imgs.device)[:, None] + torch.arange(crop_h, device=imgs.device)
    imgs = imgs.gather(2, rows[:, None, :, None, None].expand(b, n, crop_h, w, c))
    cols = off_w.to(imgs.device)[:, None] + torch.arange(crop_w, device=imgs.device)
    return imgs.gather(3, cols[:, None, None, :, None].expand(b, n, crop_h, crop_w, c))


def apply_augment(imgs: torch.Tensor, params: AugmentParams, crop_h: int, crop_w: int) -> torch.Tensor:
    """Augment a pre-resized (B, N, H, W, 3) batch with given parameters:
    photometric (if drawn), crop, flips, then normalize. Returns float32."""
    if params.photometric is not None:
        imgs = photometric_shift(imgs.to(torch.float32), params.photometric)
    imgs = _crop_batch(imgs, params.off_h, params.off_w, crop_h, crop_w)
    bcast = (slice(None),) + (None,) * 4
    imgs = torch.where(params.do_hflip.to(imgs.device)[bcast], imgs.flip(3), imgs)
    imgs = torch.where(params.do_vflip.to(imgs.device)[bcast], imgs.flip(2), imgs)
    return normalize_batch(imgs.to(torch.float32))


def augment_train(
    gen: torch.Generator, imgs: torch.Tensor, crop_h: int, crop_w: int, photometric: bool = False
) -> torch.Tensor:
    """Training augmentation (salve_tpu/training/transforms.py:109): draw
    from `gen`, then apply."""
    b, n, h, w, _ = imgs.shape
    params = draw_augment_params(gen, b, n, h, w, crop_h, crop_w, photometric)
    return apply_augment(imgs, params, crop_h, crop_w)


def preprocess_eval(imgs: torch.Tensor, crop_h: int, crop_w: int) -> torch.Tensor:
    """Deterministic center crop + normalize (salve/train_utils.py:126-160)."""
    imgs = imgs.to(torch.float32)
    h, w = imgs.shape[2:4]
    off_h = (h - crop_h) // 2
    off_w = (w - crop_w) // 2
    imgs = imgs[:, :, off_h : off_h + crop_h, off_w : off_w + crop_w]
    return normalize_batch(imgs)
