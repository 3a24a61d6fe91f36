"""JPEG decode and encode by a codec written by hand (`jpeg_codec.c`).

Counterpart of salve_tpu/native/ (whose batch loader resizes as it decodes)
and of the cv2/imageio calls of salve_tpu/rendering/dataset_renderer.py:

  * `decode_jpeg` / `decode_jpeg_bytes` return what `imageio.v2.imread`
    returns, byte for byte: (H, W, 3) uint8 RGB, or (H, W) uint8 for a
    grayscale file, with no EXIF rotation (Pillow's libjpeg-turbo at its
    defaults: ISLOW IDCT, fancy upsampling, libjpeg's YCbCr -> RGB);
  * `encode_jpeg_bytes` / `write_jpeg` return and write the bytes of
    `cv2.imencode(".jpg", img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, q])`
    (baseline 4:2:0, the standard Huffman tables);
  * `decode_resize_batch` is the training loader's batch call: what
    salve_tpu/dataset/bev_pairs.py:_load_batch_native returns through
    native/jpeg_loader.cpp (libjpeg, its float bilinear resize, then
    np.clip(np.round(x), 0, 255) to u8), from a pool of C threads.

The codec links no library, so it builds wherever there is a C compiler: `cc`
builds it at first use into its own `.so` under the git-ignored `build/`
(`build.py`); nothing is built at import. Not nvJPEG: its IDCT and chroma
upsampling are not libjpeg's. The calls go through `ctypes.CDLL`, which
releases the GIL, so writer threads encode in parallel. What the codec does
not read (arithmetic coding, lossless, 12-bit, CMYK, a progressive file with
coefficient bits unsent) raises a ValueError that names it.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Sequence, Union

import numpy as np

from salve_tpu_torch.native import build

_MSG_BYTES = 200  # MSG_BYTES of jpeg_codec.c
_P, _UL, _I = ctypes.c_void_p, ctypes.c_ulong, ctypes.c_int
_SIGNATURES = {
    "salve_jpeg_info": ([_P, _UL, _P, _P, _P, ctypes.c_char_p], _I),
    "salve_jpeg_decode": ([_P, _UL, _P, _UL, ctypes.c_char_p], _I),
    "salve_jpeg_encode": ([_P, _I, _I, _I, ctypes.POINTER(_P), ctypes.POINTER(_UL), ctypes.c_char_p], _I),
    "salve_jpeg_free": ([_P], None),
    "salve_jpeg_decode_resize_batch": ([_P, _I, _I, _I, _P, _P, _P, _I], _I),
}


def _fn(name: str):
    return build.function("jpeg_codec.c", name, *_SIGNATURES[name])


def _message(msg) -> str:
    return msg.value.decode(errors="replace")


def decode_jpeg_bytes(data: bytes) -> np.ndarray:
    """Decode a JPEG held in memory: (H, W, 3) or (H, W) uint8."""
    buf = np.frombuffer(data, dtype=np.uint8)
    msg = ctypes.create_string_buffer(_MSG_BYTES)
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if _fn("salve_jpeg_info")(buf.ctypes.data, buf.size, ctypes.byref(h), ctypes.byref(w), ctypes.byref(c), msg):
        raise ValueError(f"not a JPEG that this decoder reads: {_message(msg)}")
    out = np.empty((h.value, w.value, c.value), dtype=np.uint8)
    if _fn("salve_jpeg_decode")(buf.ctypes.data, buf.size, out.ctypes.data, out.size, msg):
        raise ValueError(f"JPEG decode failed: {_message(msg)}")
    return out[..., 0] if c.value == 1 else out


def decode_jpeg(path: Union[str, Path]) -> np.ndarray:
    """Decode a JPEG file: (H, W, 3) or (H, W) uint8, as imageio.v2.imread."""
    return decode_jpeg_bytes(Path(path).read_bytes())


def encode_jpeg_bytes(img_u8_rgb: np.ndarray, quality: int = 95) -> bytes:
    """Encode an (H, W, 3) uint8 RGB image: cv2.imencode's bytes at `quality`."""
    img = np.asarray(img_u8_rgb)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"the encoder takes (H, W, 3) uint8 RGB, got {img.shape} {img.dtype}")
    img = np.ascontiguousarray(img)
    msg = ctypes.create_string_buffer(_MSG_BYTES)
    ptr, size = ctypes.c_void_p(), ctypes.c_ulong()
    if _fn("salve_jpeg_encode")(img.ctypes.data, img.shape[0], img.shape[1], int(quality), ctypes.byref(ptr),
                             ctypes.byref(size), msg):
        raise ValueError(f"JPEG encode failed: {_message(msg)}")
    try:
        return ctypes.string_at(ptr.value, size.value)
    finally:
        _fn("salve_jpeg_free")(ptr)


def write_jpeg(path: Union[str, Path], img: np.ndarray, quality: int = 95) -> None:
    """Write `encode_jpeg_bytes(img, quality)` to `path`."""
    Path(path).write_bytes(encode_jpeg_bytes(img, quality))


def decode_resize_batch(paths: Sequence[Union[str, Path]], out_h: int, out_w: int, num_threads: int = 0) -> np.ndarray:
    """Decode JPEG files and resize each to (out_h, out_w): (N, out_h, out_w, 3) uint8.

    One C call on a pool of `num_threads` threads (0: one per CPU), the GIL
    released. A file the codec refuses raises a ValueError naming it.
    """
    n = len(paths)
    out = np.empty((n, out_h, out_w, 3), dtype=np.uint8)
    if n == 0:
        return out
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    status = np.zeros(n, dtype=np.int32)
    msgs = ctypes.create_string_buffer(_MSG_BYTES * n)
    ok = _fn("salve_jpeg_decode_resize_batch")(c_paths, n, int(out_h), int(out_w), out.ctypes.data,
                                               status.ctypes.data, msgs, int(num_threads))
    if ok != n:
        i = int(np.flatnonzero(status)[0])
        msg = msgs.raw[i * _MSG_BYTES:(i + 1) * _MSG_BYTES].split(b"\0", 1)[0].decode(errors="replace")
        raise ValueError(f"{n - ok} of {n} files not decoded; the first, {paths[i]}: {msg}")
    return out
