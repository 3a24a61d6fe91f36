"""Seeded images of the JPEG codec's checks, and their committed record.

The encoder must return cv2's bytes, and the decoder Pillow's arrays. A
machine without cv2 or Pillow (the card's) checks the codec against the
sha256 record `fixtures/codec_sha256.json`, written where both are present
(tests/test_torch_jpeg_codec.py:write_codec_record). The images are made
here from numpy seeds, so only their digests are committed.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

RECORD = Path(__file__).resolve().parent / "fixtures" / "codec_sha256.json"
QUALITY = 95
PANO_NAME = "pano_smooth_1024x2048"


def render_like(seed: int = 0, side: int = 501) -> np.ndarray:
    """A BEV-render-like image: black outside a textured blob, flat patches
    and noise inside it."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:side, 0:side]
    r = np.hypot(x - side * 0.45, y - side * 0.55)
    inside = r < side * (0.3 + 0.05 * np.sin(np.arctan2(y - side * 0.55, x - side * 0.45) * 5))
    base = np.stack([(x // 40) * 23 % 256, (y // 30) * 41 % 256, ((x + y) // 50) * 17 % 256], -1)
    img = np.clip(base + rng.integers(-25, 26, (side, side, 3)), 0, 255)
    return np.where(inside[..., None], img, 0).astype(np.uint8)


def noise(seed: int = 1, h: int = 37, w: int = 53) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def smooth_pano(seed: int = 2, h: int = 1024, w: int = 2048) -> np.ndarray:
    """A smooth equirect-like pano: gradients and slow waves, light noise.
    float64 throughout, so that a libm's last-bit differences cannot move a
    rounded pixel on another machine."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([
        x * (255.0 / (w - 1)),
        y * (255.0 / (h - 1)),
        128 + 100 * np.sin(x / 57.0 + y / 83.0),
    ], -1)
    img += rng.normal(0, 4, (h, w, 3))
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def encoder_images() -> Dict[str, Tuple[np.ndarray, int]]:
    """name -> (RGB image, quality) of the encoder fixtures."""
    return {
        "render_like_501x501": (render_like(), QUALITY),
        "noise_37x53": (noise(), QUALITY),
        PANO_NAME: (smooth_pano(), QUALITY),
    }


def sha256(data) -> str:
    return hashlib.sha256(data if isinstance(data, bytes) else np.ascontiguousarray(data).tobytes()).hexdigest()


def load_record() -> dict:
    return json.loads(RECORD.read_text())
