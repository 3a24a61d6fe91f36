"""The port's JPEG codec (salve_tpu_torch/native/jpeg_codec.c) against
libjpeg-turbo as imageio (Pillow) and cv2 run it. Tolerance: none, byte for
byte.

  * decoder: its arrays equal `imageio.v2.imread`'s on every committed
    fixture and on cv2-written files at 1x1, 7x9, 17x33 and 501x501 (and
    1024x2048 at q95 in 4:2:0 and progressive): chroma 4:2:0, 4:2:2, 4:4:0,
    4:4:4 and 4:1:1, progressive, restart intervals, optimized Huffman
    tables, grayscale, at qualities 1, 50, 75, 95 and 100;
  * encoder: its bytes equal `cv2.imencode(".jpg", img[..., ::-1],
    [IMWRITE_JPEG_QUALITY, q])`'s at the same sizes and qualities;
  * refusals: an arithmetic, a lossless, a 12-bit, a CMYK stream and a
    progressive file with coefficient bits unsent raise a ValueError that
    names what is not read;
  * the committed record `native/fixtures/codec_sha256.json` (what the
    card's smoke checks, where there is neither cv2 nor Pillow) equals what
    cv2 and Pillow give here.
"""

import io
import json
import re

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest

from salve_tpu_torch.native import codec_fixtures as cf
from salve_tpu_torch.native import jpeg

SIZES = [(1, 1), (7, 9), (17, 33), (501, 501)]
QUALITIES = [1, 50, 75, 95, 100]
SAMPLING = {
    "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
    "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
    "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
    "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
    "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
}
VARIANTS = {
    **{f"sampling_{k}": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, v] for k, v in SAMPLING.items()},
    "progressive": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
    "restart_interval": [cv2.IMWRITE_JPEG_RST_INTERVAL, 2],
    "optimize": [cv2.IMWRITE_JPEG_OPTIMIZE, 1],
    "grayscale": [],
}


def _image(h: int, w: int, seed: int) -> np.ndarray:
    """Smooth gradients with noise: both flat and busy blocks."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255.0 / max(w - 1, 1), y * 255.0 / max(h - 1, 1), 128 + 90 * np.sin(x / 9.0 + y / 13.0)], -1)
    return np.clip(base + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)


def _cv2_bytes(img: np.ndarray, quality: int, extra=()) -> bytes:
    src = img if img.ndim == 2 else img[..., ::-1]
    ok, buf = cv2.imencode(".jpg", src, [cv2.IMWRITE_JPEG_QUALITY, quality, *extra])
    assert ok
    return buf.tobytes()


def _assert_decodes_as_imageio(data: bytes) -> None:
    want = imageio.imread(io.BytesIO(data))
    got = jpeg.decode_jpeg_bytes(data)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_decoder_equals_imageio_on_cv2_files(size, variant):
    img = _image(*size, seed=size[0] * 1000 + size[1])
    if variant == "grayscale":
        img = img[..., 1]
    for q in QUALITIES:
        _assert_decodes_as_imageio(_cv2_bytes(img, q, VARIANTS[variant]))


@pytest.mark.parametrize("variant", ["sampling_420", "progressive"])
def test_decoder_equals_imageio_on_a_full_size_pano(variant):
    _assert_decodes_as_imageio(_cv2_bytes(cf.smooth_pano(seed=5), 95, VARIANTS[variant]))


@pytest.mark.parametrize("size", SIZES + [(1024, 2048)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_encoder_bytes_equal_cv2(size):
    if size == (1024, 2048):
        img, qualities = cf.smooth_pano(seed=6), [95]
    else:
        img, qualities = _image(*size, seed=size[0] + 7 * size[1]), QUALITIES
    for q in qualities:
        assert jpeg.encode_jpeg_bytes(img, q) == _cv2_bytes(img, q)


def test_encoder_bytes_equal_cv2_on_noise_and_flat_images():
    """Noise (long AC runs, 0xFF stuffing) and flat images (runs of zeros,
    ZRL codes), at widths and heights on both sides of a whole MCU."""
    rng = np.random.default_rng(11)
    for h, w in [(15, 17), (16, 16), (31, 33), (2, 3), (3, 2)]:
        for img in (rng.integers(0, 256, (h, w, 3), dtype=np.uint8), np.full((h, w, 3), 200, np.uint8)):
            for q in (10, 95, 100):
                assert jpeg.encode_jpeg_bytes(img, q) == _cv2_bytes(img, q)


def test_write_jpeg_writes_the_encoded_bytes(tmp_path):
    img = _image(9, 7, seed=3)
    jpeg.write_jpeg(tmp_path / "a.jpg", img)
    assert (tmp_path / "a.jpg").read_bytes() == _cv2_bytes(img, 95)
    with pytest.raises(ValueError, match="uint8 RGB"):
        jpeg.encode_jpeg_bytes(img[..., 0])
    with pytest.raises(ValueError, match="uint8 RGB"):
        jpeg.encode_jpeg_bytes(img.astype(np.float32))


# -- refusals -------------------------------------------------------------------


def _sof_offset(data: bytes) -> int:
    """Offset of the SOF marker's 0xFF in a baseline stream."""
    m = re.search(b"\xff[\xc0\xc1\xc2]", data)
    assert m
    return m.start()


def _with_sof_byte(data: bytes, offset: int, value: int) -> bytes:
    b = bytearray(data)
    b[_sof_offset(data) + offset] = value
    return bytes(b)


def _cmyk_bytes() -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(0).integers(0, 256, (8, 8, 4), dtype=np.uint8), "CMYK").save(buf, "JPEG")
    return buf.getvalue()


def _progressive_cut_after(n_scans: int) -> bytes:
    """A progressive file with only its first scans, then EOI."""
    data = _cv2_bytes(_image(24, 24, seed=9), 90, VARIANTS["progressive"])
    sos = [m.start() for m in re.finditer(b"\xff\xda", data)]
    assert len(sos) > n_scans
    return data[: sos[n_scans]] + b"\xff\xd9"


@pytest.mark.parametrize(
    "name,make,match",
    [
        ("arithmetic", lambda d: _with_sof_byte(d, 1, 0xC9), "arithmetic coding"),
        ("lossless", lambda d: _with_sof_byte(d, 1, 0xC3), "lossless"),
        ("12-bit", lambda d: _with_sof_byte(d, 4, 12), "12-bit precision"),
        ("cmyk", lambda d: _cmyk_bytes(), "4 components"),
        ("progressive_unsent", lambda d: _progressive_cut_after(2), "scans leave coefficient"),
        ("not_jpeg", lambda d: b"\x89PNG\r\n\x1a\n" + bytes(16), "no SOI"),
        ("truncated_header", lambda d: d[:40], "ends early"),
    ],
)
def test_streams_the_decoder_does_not_read_raise(name, make, match):
    data = make(_cv2_bytes(_image(16, 16, seed=1), 90))
    with pytest.raises(ValueError, match=match):
        jpeg.decode_jpeg_bytes(data)


def test_a_progressive_file_with_every_scan_decodes():
    data = _cv2_bytes(_image(24, 24, seed=9), 90, VARIANTS["progressive"])
    _assert_decodes_as_imageio(data)


# -- the committed record -----------------------------------------------------------


def _libjpeg_turbo_versions() -> dict:
    from PIL import features

    build = re.search(r"JPEG:\s+(.*)", cv2.getBuildInformation())
    return {"cv2": f"{cv2.__version__}, {build.group(1).strip() if build else 'unknown'}",
            "pillow_libjpeg_turbo": features.version("libjpeg_turbo")}


def codec_record() -> dict:
    """What the record holds: the sha256 of cv2's bytes for each encoder
    fixture, and of Pillow's array for the decode of the pano's bytes."""
    images = cf.encoder_images()
    out = {"encode": {}, "versions": _libjpeg_turbo_versions()}
    for name, (img, q) in sorted(images.items()):
        out["encode"][name] = {"shape": list(img.shape), "quality": q, "sha256": cf.sha256(_cv2_bytes(img, q))}
    pano, q = images[cf.PANO_NAME]
    decoded = imageio.imread(io.BytesIO(_cv2_bytes(pano, q)))
    out["decode"] = {cf.PANO_NAME: {"shape": list(decoded.shape), "sha256": cf.sha256(decoded)}}
    return out


def write_codec_record() -> None:
    """Rewrite the record (run by hand: `python -c "import sys; sys.path.insert(0, 'tests');
    import test_torch_jpeg_codec as t; t.write_codec_record()"`)."""
    cf.RECORD.write_text(json.dumps(codec_record(), indent=1) + "\n")


def test_committed_record_is_what_cv2_and_pillow_give():
    rec = cf.load_record()
    want = codec_record()
    assert rec["encode"] == want["encode"] and rec["decode"] == want["decode"]
    assert set(rec["versions"]) == {"cv2", "pillow_libjpeg_turbo"}


def test_codec_meets_the_record_without_cv2_or_pillow():
    """The check the card's smoke makes: the port's bytes and arrays
    against the record alone."""
    rec = cf.load_record()
    for name, (img, q) in cf.encoder_images().items():
        data = jpeg.encode_jpeg_bytes(img, q)
        assert cf.sha256(data) == rec["encode"][name]["sha256"], name
        if name in rec["decode"]:
            assert cf.sha256(jpeg.decode_jpeg_bytes(data)) == rec["decode"][name]["sha256"]
