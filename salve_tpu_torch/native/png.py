"""A PNG reader on the standard library's zlib and numpy, equal to `imageio.v2.imread`.

Reads what the pipeline writes and reads: 16-bit grayscale (the u16
millimetre depth maps of salve_tpu/depth/cache.py:63, which `imageio.imwrite`
writes through Pillow), 8-bit grayscale and 8-bit RGB, not interlaced. It
returns (H, W) uint16, (H, W) uint8 or (H, W, 3) uint8, as imageio does.
Anything else (palette, alpha, other bit depths, Adam7 interlacing, a bad
CRC) raises: there is no fallback to another reader.

Pillow's writer picks a filter per row, so rows of all five filter types
occur. `unfilter` runs them through a C shim of its own (`png_unfilter.c`,
built with `cc` at first use): Average and Paeth are sequential along a row.
`unfilter_plain` is the same in numpy and Python, the shim's yardstick.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path
from typing import Sequence, Union

import numpy as np

from salve_tpu_torch.native import build

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (colour type, bit depth) -> (channels, numpy dtype of a sample)
_FORMATS = {(0, 16): (1, ">u2"), (0, 8): (1, "u1"), (2, 8): (3, "u1")}


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: truncated or bad CRC")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG file ends before IEND")


def unfilter_plain(filtered: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """(height, stride) uint8 rows from `height` rows of 1 filter byte +
    `stride` bytes: numpy for None/Sub/Up, a Python loop for Average/Paeth."""
    rows = filtered.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.int64)
    for y in range(height):
        kind, raw = int(rows[y, 0]), rows[y, 1:].astype(np.int64)
        if kind == 0:
            cur = raw
        elif kind == 1:
            cur = np.cumsum(raw.reshape(-1, bpp), axis=0).reshape(-1) % 256
        elif kind == 2:
            cur = (raw + prior) % 256
        elif kind in (3, 4):
            r, p = raw.tolist(), prior.tolist()
            c = [0] * stride
            for x in range(stride):
                a = c[x - bpp] if x >= bpp else 0
                if kind == 3:
                    pred = (a + p[x]) >> 1
                else:
                    b, cc = p[x], (p[x - bpp] if x >= bpp else 0)
                    q = a + b - cc
                    pa, pb, pc = abs(q - a), abs(q - b), abs(q - cc)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
                c[x] = (r[x] + pred) & 255
            cur = np.asarray(c, np.int64)
        else:
            raise ValueError(f"PNG row {y}: filter type {kind}")
        out[y] = cur
        prior = cur
    return out


def unfilter(filtered: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """`unfilter_plain` through the C shim."""
    fn = build.function("png_unfilter.c", "salve_png_unfilter",
                        [ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_int, ctypes.c_void_p], ctypes.c_int)
    filtered = np.ascontiguousarray(filtered, dtype=np.uint8)
    if filtered.size != height * (stride + 1):
        raise ValueError(f"PNG image data holds {filtered.size} bytes, not {height} rows of {stride + 1}")
    out = np.empty((height, stride), np.uint8)
    bad = fn(filtered.ctypes.data, height, stride, bpp, out.ctypes.data)
    if bad:
        raise ValueError(f"PNG row {bad - 1}: filter type {int(filtered[(bad - 1) * (stride + 1)])}")
    return out


def decode_png_bytes(data: bytes, plain: bool = False) -> np.ndarray:
    """Decode a PNG held in memory (module docstring); `plain` unfilters
    with `unfilter_plain`."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind[0:1].isupper() and kind not in (b"IEND", b"PLTE"):
            raise ValueError(f"PNG critical chunk {kind!r} is not read")
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    width, height, depth, colour, compression, filtering, interlace = header
    if (colour, depth) not in _FORMATS:
        raise ValueError(f"PNG colour type {colour} at bit depth {depth} is not read "
                         "(16-bit grayscale, 8-bit grayscale and 8-bit RGB are)")
    if compression != 0 or filtering != 0:
        raise ValueError("PNG compression or filter method other than 0")
    if interlace != 0:
        raise ValueError("Adam7-interlaced PNGs are not read")
    channels, dtype = _FORMATS[(colour, depth)]
    bpp = channels * depth // 8
    stride = width * bpp
    filtered = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = (unfilter_plain if plain else unfilter)(filtered, height, stride, bpp)
    img = rows.view(dtype).reshape(height, width, channels).astype(dtype[-2:], copy=False)
    return img[..., 0] if channels == 1 else img


def read_png(path: Union[str, Path]) -> np.ndarray:
    """Read a PNG file: (H, W) uint16 or uint8, or (H, W, 3) uint8."""
    return decode_png_bytes(Path(path).read_bytes())


def encode_png(img: np.ndarray, filters: Sequence[int] = (0, 1, 2, 3, 4)) -> bytes:
    """PNG bytes of a (H, W) uint16 or uint8, or (H, W, 3) uint8 image, row y
    filtered with `filters[y % len(filters)]`: a writer that puts every
    filter type where a test or a timing needs it (forward filtering reads
    only unfiltered bytes, so it is vectorized)."""
    img = np.asarray(img)
    channels = 1 if img.ndim == 2 else img.shape[2]
    depth = img.dtype.itemsize * 8
    colour = 0 if channels == 1 else 2
    if (colour, depth) not in _FORMATS:
        raise ValueError(f"cannot write a {img.dtype} image of {channels} channels")
    height, width = img.shape[:2]
    bpp = channels * depth // 8
    raw = np.ascontiguousarray(img.astype(_FORMATS[(colour, depth)][1])).view(np.uint8).reshape(height, -1)
    cur = raw.astype(np.int64)
    prior = np.vstack([np.zeros((1, cur.shape[1]), np.int64), cur[:-1]])
    left = np.hstack([np.zeros((height, bpp), np.int64), cur[:, :-bpp]])
    up_left = np.hstack([np.zeros((height, bpp), np.int64), prior[:, :-bpp]])
    p = left + prior - up_left
    pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - up_left)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, up_left))
    preds = [np.zeros_like(cur), left, prior, (left + prior) >> 1, paeth]
    kinds = np.array([filters[y % len(filters)] for y in range(height)])
    filtered = (cur - np.choose(kinds[:, None], preds)) % 256
    body = np.hstack([kinds[:, None], filtered]).astype(np.uint8).tobytes()

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    ihdr = struct.pack(">IIBBBBB", width, height, depth, colour, 0, 0, 0)
    return SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(body)) + chunk(b"IEND", b"")
