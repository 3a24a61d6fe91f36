"""JPEG decode through the system's libjpeg, equal to `imageio.v2.imread`.

Counterpart of salve_tpu/native/ (whose batch loader resizes as it decodes);
this one returns the decoded pixels as imageio does: (H, W, 3) uint8 RGB, or
(H, W) uint8 for a grayscale file. The decode settings are Pillow's
(`jpeg_decode.c`), so the arrays are equal byte for byte. Not nvJPEG: its
IDCT and chroma upsampling are not libjpeg's.

The shim is built with `cc` at first use and linked against `-ljpeg`; that
needs libjpeg's header and its development symlink. Where they are missing
`decode_jpeg` raises and names what is missing. Nothing is built at import.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Union

import numpy as np

from salve_tpu_torch.native import build

_MSG_BYTES = 200  # libjpeg's JMSG_LENGTH_MAX
_BOUND = False


def _lib() -> ctypes.CDLL:
    global _BOUND
    try:
        lib = build.load("jpeg_decode.c", ("-ljpeg",))
    except RuntimeError as err:
        raise RuntimeError(f"the JPEG decode needs libjpeg's header (jpeglib.h) and library (-ljpeg): {err}") from err
    if not _BOUND:
        P, UL = ctypes.c_void_p, ctypes.c_ulong
        lib.salve_jpeg_info.argtypes = [P, UL, P, P, P, ctypes.c_char_p]
        lib.salve_jpeg_decode.argtypes = [P, UL, P, UL, ctypes.c_char_p]
        lib.salve_jpeg_info.restype = lib.salve_jpeg_decode.restype = ctypes.c_int
        _BOUND = True
    return lib


def decode_jpeg_bytes(data: bytes) -> np.ndarray:
    """Decode a JPEG held in memory: (H, W, 3) or (H, W) uint8."""
    lib = _lib()
    buf = np.frombuffer(data, dtype=np.uint8)
    msg = ctypes.create_string_buffer(_MSG_BYTES)
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.salve_jpeg_info(buf.ctypes.data, buf.size, ctypes.byref(h), ctypes.byref(w), ctypes.byref(c), msg):
        raise ValueError(f"not a JPEG that this decoder reads: {msg.value.decode(errors='replace')}")
    out = np.empty((h.value, w.value, c.value), dtype=np.uint8)
    if lib.salve_jpeg_decode(buf.ctypes.data, buf.size, out.ctypes.data, out.size, msg):
        raise ValueError(f"JPEG decode failed: {msg.value.decode(errors='replace')}")
    return out[..., 0] if c.value == 1 else out


def decode_jpeg(path: Union[str, Path]) -> np.ndarray:
    """Decode a JPEG file: (H, W, 3) or (H, W) uint8, as imageio.v2.imread."""
    return decode_jpeg_bytes(Path(path).read_bytes())

