"""Torch-free tuple transforms with the reference's class names (port of
salve_tpu/utils/transform.py).

The 23 Pair/Quadruplet/Sextuplet transform classes (Compose, ToTensor,
Normalize, Resize, Crop, random flips, photometric shift) and
`get_imagenet_transform_lists`, on numpy. salve_tpu calls
`cv2.resize(INTER_LINEAR)` and `cv2.copyMakeBorder(BORDER_CONSTANT)`
(salve_tpu/utils/transform.py:26-38); the card's machine has no cv2, so both
are written here:

* `resize_linear`: on uint8, cv2's fixed-point bilinear (11-bit weights
  rounded from float32 sample positions, columns clamped with a zero
  weight, rows clamped with their weight kept, and the vertical pass's
  ((b0 * (r0 >> 4)) >> 16) + ((b1 * (r1 >> 4)) >> 16) + 2) >> 2), byte for
  byte cv2 5.0.0's; on float images, the bilinear of the exact (float64)
  sample positions computed in float64 and rounded once, which is what
  cv2 5.0.0's IPP path computes within 2^-15 on [0, 255] (its own float
  path, which cv2 takes for images of one row, rounds the positions to
  float32 first);
* `pad_image`: the constant border, each channel's value rounded to the
  image's dtype as cv2 saturates it.

ToTensor* returns float32 CHW numpy arrays (the torch-tensor role without
torch). The training path does not use these classes (training/transforms.py
augments on the device); they serve host-side tooling.
"""

from __future__ import annotations

import random
from typing import List, Sequence, Tuple

import numpy as np

from salve_tpu_torch.utils.normalization_utils import get_imagenet_mean_std

# cv2's fixed-point weights (INTER_RESIZE_COEF_BITS).
_COEF_BITS = 11


def _sample_taps(src: int, dst: int, clamp_weight: bool, dtype):
    """(first tap, second tap, weight of the second) of each output sample
    of a bilinear resize from `src` to `dst` samples (half-pixel centres).

    The positions are computed in float64 and rounded to `dtype`. A sample
    left of the first or right of the last source sample reads the edge
    twice; with `clamp_weight` its weight becomes 0 (cv2's columns), else it
    keeps its fraction (cv2's rows).
    """
    pos = ((np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5).astype(dtype)
    first = np.floor(pos).astype(np.int64)
    frac = (pos - first.astype(dtype)).astype(dtype)
    if clamp_weight:
        outside = (first < 0) | (first >= src - 1)
        frac = np.where(outside, dtype(0), frac).astype(dtype)
        first = np.where(first < 0, 0, np.where(first >= src - 1, src - 1, first))
    return np.clip(first, 0, src - 1), np.clip(first + 1, 0, src - 1), frac


def resize_linear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """`cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)` for an
    (H, W) or (H, W, C) image, size = (h, w) (module docstring)."""
    h, w = size
    H, W = img.shape[:2]
    row = (h, 1) + (1,) * (img.ndim - 2)
    col = (1, w) + (1,) * (img.ndim - 2)
    if img.dtype == np.uint8:
        x0, x1, fx = _sample_taps(W, w, True, np.float32)
        y0, y1, fy = _sample_taps(H, h, False, np.float32)
        scale = np.float32(1 << _COEF_BITS)
        # saturate_cast<short>(float): round to nearest, ties to even.
        a0, a1 = np.rint((np.float32(1) - fx) * scale).astype(np.int64), np.rint(fx * scale).astype(np.int64)
        b0, b1 = np.rint((np.float32(1) - fy) * scale).astype(np.int64), np.rint(fy * scale).astype(np.int64)
        src = img.astype(np.int64)
        rows = src[:, x0] * a0.reshape(col) + src[:, x1] * a1.reshape(col)
        out = (((b0.reshape(row) * (rows[y0] >> 4)) >> 16) + ((b1.reshape(row) * (rows[y1] >> 4)) >> 16) + 2) >> 2
        out = np.clip(out, 0, 255).astype(np.uint8)
    else:
        x0, x1, fx = _sample_taps(W, w, True, np.float64)
        y0, y1, fy = _sample_taps(H, h, True, np.float64)
        src = img.astype(np.float64)
        rows = src[:, x0] * (1.0 - fx).reshape(col) + src[:, x1] * fx.reshape(col)
        out = (rows[y0] * (1.0 - fy).reshape(row) + rows[y1] * fy.reshape(row)).astype(img.dtype)
    # cv2 returns a one-channel image without its channel axis.
    return out[..., 0] if out.ndim == 3 and out.shape[2] == 1 else out


def pad_image(img: np.ndarray, pad_h: int, pad_w: int, padding_vals) -> np.ndarray:
    """`cv2.copyMakeBorder(img, 0, pad_h, 0, pad_w, BORDER_CONSTANT,
    value=padding_vals)`: bottom and right borders of one value a channel
    (saturated to the image's dtype; missing channels read 0)."""
    h, w = img.shape[:2]
    channels = img.shape[2] if img.ndim == 3 else 1
    vals = np.zeros(channels, np.float64)
    given = np.atleast_1d(np.asarray(padding_vals, np.float64))[:channels]
    vals[: len(given)] = given
    if np.issubdtype(img.dtype, np.integer):
        info = np.iinfo(img.dtype)
        vals = np.clip(np.rint(vals), info.min, info.max)
    out = np.empty((h + pad_h, w + pad_w) + img.shape[2:], img.dtype)
    out[...] = vals.astype(img.dtype).reshape((channels,) if img.ndim == 3 else ())
    out[:h, :w] = img
    return out


class _ComposeN:
    """Chain tuple transforms (ComposePair/Quadruplet/Sextuplet)."""

    def __init__(self, transforms: Sequence) -> None:
        self.transforms = list(transforms)

    def __call__(self, *imgs):
        for t in self.transforms:
            imgs = t(*imgs)
        return imgs


class _ToTensorN:
    """HWC uint8 -> float32 CHW arrays (the torch ToTensor role, torch-free)."""

    def __call__(self, *imgs):
        return tuple(
            np.ascontiguousarray(img.transpose(2, 0, 1)).astype(np.float32)
            for img in imgs
        )


class _NormalizeN:
    """Per-channel (x - mean) / std on CHW float arrays."""

    def __init__(self, mean, std=None) -> None:
        self.mean = np.asarray(mean, dtype=np.float32).reshape(-1, 1, 1)
        self.std = (
            np.asarray(std, dtype=np.float32).reshape(-1, 1, 1)
            if std is not None
            else None
        )

    def __call__(self, *imgs):
        if self.std is None:
            return tuple(img - self.mean for img in imgs)
        return tuple((img - self.mean) / self.std for img in imgs)


class _ResizeN:
    def __init__(self, size: Tuple[int, int]) -> None:
        self.size = size

    def __call__(self, *imgs):
        return tuple(resize_linear(img, self.size) for img in imgs)


class CropBase:
    """Shared crop logic (parity: transform.py:302) — same offset per tuple."""

    def __init__(
        self,
        size: Tuple[int, int],
        crop_type: str = "center",
        padding=None,
    ) -> None:
        self.crop_h, self.crop_w = size
        if crop_type not in ("rand", "center"):
            raise ValueError("crop type error: rand | center")
        self.crop_type = crop_type
        self.padding = padding

    def _offsets_and_pad(self, h: int, w: int) -> Tuple[int, int, int, int]:
        pad_h = max(self.crop_h - h, 0)
        pad_w = max(self.crop_w - w, 0)
        if (pad_h > 0 or pad_w > 0) and self.padding is None:
            raise RuntimeError("Crop() needs padding while padding argument is None")
        h, w = h + pad_h, w + pad_w
        if self.crop_type == "rand":
            h_off = random.randint(0, h - self.crop_h)
            w_off = random.randint(0, w - self.crop_w)
        else:
            h_off = int((h - self.crop_h) / 2)
            w_off = int((w - self.crop_w) / 2)
        return h_off, w_off, pad_h, pad_w

    def __call__(self, *imgs):
        h, w = imgs[0].shape[:2]
        h_off, w_off, pad_h, pad_w = self._offsets_and_pad(h, w)
        out = []
        for img in imgs:
            if pad_h > 0 or pad_w > 0:
                img = pad_image(img, pad_h, pad_w, self.padding)
            out.append(img[h_off : h_off + self.crop_h, w_off : w_off + self.crop_w])
        return tuple(out)


class _RandomHorizontalFlipN:
    """Same flip decision for the whole tuple (parity :509)."""

    def __init__(self, p: float = 0.5) -> None:
        self.p = p

    def __call__(self, *imgs):
        if random.random() < self.p:
            return tuple(np.ascontiguousarray(img[:, ::-1]) for img in imgs)
        return imgs


class _RandomVerticalFlipN:
    def __init__(self, p: float = 0.5) -> None:
        self.p = p

    def __call__(self, *imgs):
        if random.random() < self.p:
            return tuple(np.ascontiguousarray(img[::-1]) for img in imgs)
        return imgs


class PhotometricShiftQuadruplet:
    """Per-image independent brightness/contrast/saturation/hue jitter.

    Parity: transform.py:619 (ColorJitter ranges 0.5/0.5/0.5/0.05); the
    torchvision dependency is replaced by the same formulas used in the
    device pipeline (training/transforms.photometric_shift).
    """

    def __init__(
        self,
        jitter_types: List[str] = ["brightness", "contrast", "saturation", "hue"],
    ) -> None:
        self.brightness = 0.5 if "brightness" in jitter_types else 0.0
        self.contrast = 0.5 if "contrast" in jitter_types else 0.0
        self.saturation = 0.5 if "saturation" in jitter_types else 0.0
        self.hue = 0.05 if "hue" in jitter_types else 0.0

    def _jitter_one(self, img: np.ndarray) -> np.ndarray:
        out = img.astype(np.float32)

        def gray(x):
            return 0.299 * x[..., :1] + 0.587 * x[..., 1:2] + 0.114 * x[..., 2:3]

        if self.brightness:
            out = out * random.uniform(1 - self.brightness, 1 + self.brightness)
        if self.contrast:
            c = random.uniform(1 - self.contrast, 1 + self.contrast)
            m = gray(out).mean()
            out = (out - m) * c + m
        if self.saturation:
            s = random.uniform(1 - self.saturation, 1 + self.saturation)
            g = gray(out)
            out = (out - g) * s + g
        if self.hue:
            theta = random.uniform(-self.hue, self.hue) * 2 * np.pi
            y = gray(out)[..., 0]
            i = 0.596 * out[..., 0] - 0.274 * out[..., 1] - 0.322 * out[..., 2]
            q = 0.211 * out[..., 0] - 0.523 * out[..., 1] + 0.312 * out[..., 2]
            i, q = (
                np.cos(theta) * i - np.sin(theta) * q,
                np.sin(theta) * i + np.cos(theta) * q,
            )
            out = np.stack(
                [
                    y + 0.956 * i + 0.621 * q,
                    y - 0.272 * i - 0.647 * q,
                    y - 1.106 * i + 1.703 * q,
                ],
                axis=-1,
            )
        return np.clip(out, 0, 255).astype(img.dtype)

    def __call__(self, *imgs):
        return tuple(self._jitter_one(img) for img in imgs)


# Alias used by train_utils.get_train_transform in the reference.
PhotometricShift = PhotometricShiftQuadruplet


def _arity_check(n: int):
    def deco(cls):
        orig = cls.__call__

        def checked(self, *imgs):
            if len(imgs) != n:
                raise ValueError(f"{cls.__name__} expects {n} images, got {len(imgs)}")
            return orig(self, *imgs)

        cls.__call__ = checked
        return cls

    return deco


# Pair / Quadruplet / Sextuplet concrete names (reference API).
@_arity_check(2)
class ComposePair(_ComposeN): ...
@_arity_check(4)
class ComposeQuadruplet(_ComposeN): ...
@_arity_check(6)
class ComposeSextuplet(_ComposeN): ...

@_arity_check(2)
class ToTensorPair(_ToTensorN): ...
@_arity_check(4)
class ToTensorQuadruplet(_ToTensorN): ...
@_arity_check(6)
class ToTensorSextuplet(_ToTensorN): ...

@_arity_check(2)
class NormalizePair(_NormalizeN): ...
@_arity_check(4)
class NormalizeQuadruplet(_NormalizeN): ...
@_arity_check(6)
class NormalizeSextuplet(_NormalizeN): ...

@_arity_check(2)
class ResizePair(_ResizeN): ...
@_arity_check(4)
class ResizeQuadruplet(_ResizeN): ...
@_arity_check(6)
class ResizeSextuplet(_ResizeN): ...

@_arity_check(2)
class CropPair(CropBase): ...
@_arity_check(4)
class CropQuadruplet(CropBase): ...
@_arity_check(6)
class CropSextuplet(CropBase): ...

@_arity_check(2)
class RandomHorizontalFlipPair(_RandomHorizontalFlipN): ...
@_arity_check(4)
class RandomHorizontalFlipQuadruplet(_RandomHorizontalFlipN): ...
@_arity_check(6)
class RandomHorizontalFlipSextuplet(_RandomHorizontalFlipN): ...
# The reference has a typo'd name; keep it as an alias for drop-in parity.
RandomHorizontalFlipSextuuplet = RandomHorizontalFlipSextuplet

@_arity_check(2)
class RandomVerticalFlipPair(_RandomVerticalFlipN): ...
@_arity_check(4)
class RandomVerticalFlipQuadruplet(_RandomVerticalFlipN): ...
@_arity_check(6)
class RandomVerticalFlipSextuplet(_RandomVerticalFlipN): ...


def get_imagenet_transform_lists():
    """Convenience: (train, eval) Compose chains matching train_utils.py."""
    mean, std = get_imagenet_mean_std()
    train = ComposeQuadruplet(
        [
            ResizeQuadruplet((234, 234)),
            CropQuadruplet((224, 224), crop_type="rand", padding=mean),
            RandomHorizontalFlipQuadruplet(),
            RandomVerticalFlipQuadruplet(),
            ToTensorQuadruplet(),
            NormalizeQuadruplet(mean=mean, std=std),
        ]
    )
    evaln = ComposeQuadruplet(
        [
            ResizeQuadruplet((234, 234)),
            CropQuadruplet((224, 224), crop_type="center", padding=mean),
            ToTensorQuadruplet(),
            NormalizeQuadruplet(mean=mean, std=std),
        ]
    )
    return train, evaln
