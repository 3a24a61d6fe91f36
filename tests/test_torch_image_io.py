"""The port's image readers against imageio, and the scoring CLI without imageio.

`salve_tpu_torch/native/`: a JPEG codec written by hand (its own tests are
tests/test_torch_jpeg_codec.py), and a PNG reader on zlib and numpy. Both
must return exactly `imageio.v2.imread`'s arrays (tolerance: none, byte for byte):
  * on the committed fixtures (`salve_tpu_torch/native/fixtures/`, written
    by `write_fixtures` below with Pillow and the port's PNG writer):
    4:2:0, 4:2:2 and 4:4:4 chroma, grayscale, odd sizes, progressive, an
    EXIF orientation (imageio applies none), and PNGs whose rows use all
    five filter types; their sha256 record is what the card's smoke checks;
  * on u16 depth PNGs that imageio writes from seeded arrays.
Then `cli/test_fused.py` scores a synthetic building (JPEG panos and cached
u16 depth PNGs from salve_tpu's materializer) in a process where imageio,
PIL and cv2 are absent; its batch files equal, to the bit, those of a run
whose loaders read through imageio.
"""

import hashlib
import io
import json
import pathlib
import struct
import subprocess
import sys
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from salve_tpu_torch.geometry.sim2 import Sim2
from salve_tpu_torch.native import jpeg, png
from salve_tpu_torch.rendering import bev_pair

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "salve_tpu_torch" / "native" / "fixtures"
RECORD = FIXTURES / "imageio_sha256.json"
HIDDEN = ("imageio", "PIL", "cv2")


def _fixture_images():
    """name -> (array, save kwargs or PNG filters) of the committed fixtures."""
    rng = np.random.default_rng(0)

    def photo(h, w):
        y, x = np.mgrid[0:h, 0:w]
        base = np.stack([(x * 5) % 256, (y * 7) % 256, ((x + y) * 3) % 256], -1)
        return np.clip(base + rng.integers(0, 40, (h, w, 3)), 0, 255).astype(np.uint8)

    return {
        "rgb420_37x53.jpg": (photo(37, 53), dict(quality=90, subsampling=2)),
        "rgb422_40x33.jpg": (photo(40, 33), dict(quality=85, subsampling=1)),
        "rgb444_29x61.jpg": (photo(29, 61), dict(quality=95, subsampling=0)),
        "gray_31x47.jpg": (photo(31, 47)[..., 0], dict(quality=88)),
        "progressive_45x39.jpg": (photo(45, 39), dict(quality=80, progressive=True)),
        "exif_orientation6_24x40.jpg": (photo(24, 40), dict(quality=92, exif_orientation=6)),
        "depth_u16_23x41.png": (rng.integers(0, 65535, (23, 41)).astype(np.uint16), (0, 1, 2, 3, 4)),
        "gray8_17x29.png": (rng.integers(0, 255, (17, 29)).astype(np.uint8), (4, 3, 2, 1, 0)),
        "rgb8_13x19.png": (rng.integers(0, 255, (13, 19, 3)).astype(np.uint8), (3, 4, 1, 0, 2)),
    }


def _sha(a: np.ndarray) -> dict:
    return {"shape": list(a.shape), "dtype": str(a.dtype), "sha256": hashlib.sha256(a.tobytes()).hexdigest()}


def write_fixtures(out: pathlib.Path = FIXTURES) -> None:
    """Write the fixtures and imageio's sha256 of each (run by hand:
    `python -c "import sys; sys.path.insert(0, 'tests'); import test_torch_image_io as t; t.write_fixtures()"`)."""
    from PIL import Image

    out.mkdir(parents=True, exist_ok=True)
    for name, (img, how) in _fixture_images().items():
        if name.endswith(".png"):
            (out / name).write_bytes(png.encode_png(img, how))
            continue
        how = dict(how)
        im = Image.fromarray(img)
        if "exif_orientation" in how:
            exif = im.getexif()
            exif[0x0112] = how.pop("exif_orientation")
            how["exif"] = exif.tobytes()
        im.save(out / name, **how)
    RECORD.write_text(json.dumps({n: _sha(imageio.imread(out / n)) for n in sorted(_fixture_images())},
                                 indent=1) + "\n")


NAMES = sorted(_fixture_images())


@pytest.mark.parametrize("name", NAMES)
def test_fixture_equals_imageio_and_its_record(name):
    want = imageio.imread(FIXTURES / name)
    got = bev_pair.read_image(str(FIXTURES / name))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert _sha(got) == json.loads(RECORD.read_text())[name]


def test_fixtures_cover_the_formats():
    """Chroma 4:2:0/4:2:2/4:4:4, grayscale, progressive, an EXIF rotation
    imageio does not apply, and every PNG filter type."""
    from PIL import Image

    sampling = {n: Image.open(FIXTURES / n).layer for n in NAMES if n.endswith(".jpg") and "gray" not in n}
    factors = {n: tuple(l[1:3] for l in layers) for n, layers in sampling.items()}
    assert factors["rgb420_37x53.jpg"][0] == (2, 2) and factors["rgb422_40x33.jpg"][0] == (2, 1)
    assert factors["rgb444_29x61.jpg"][0] == (1, 1)
    assert Image.open(FIXTURES / "progressive_45x39.jpg").info.get("progressive")
    assert Image.open(FIXTURES / "exif_orientation6_24x40.jpg").getexif()[0x0112] == 6
    assert imageio.imread(FIXTURES / "exif_orientation6_24x40.jpg").shape == (24, 40, 3)
    assert jpeg.decode_jpeg(FIXTURES / "gray_31x47.jpg").ndim == 2
    for name in ("depth_u16_23x41.png", "gray8_17x29.png", "rgb8_13x19.png"):
        assert sorted(set(_filter_types((FIXTURES / name).read_bytes()))) == [0, 1, 2, 3, 4]


def _filter_types(data: bytes):
    """The filter type of each row of a PNG."""
    chunks = list(png._chunks(data))
    _, h = struct.unpack(">II", chunks[0][1][:8])
    raw = zlib.decompress(b"".join(b for k, b in chunks if k == b"IDAT"))
    return [raw[y * (len(raw) // h)] for y in range(h)]


@pytest.mark.parametrize("kind", ["noise", "smooth", "ramps"])
def test_depth_pngs_imageio_writes_read_equal(tmp_path, kind):
    """u16 depth maps as salve_tpu/depth/cache.py writes them (imageio,
    through Pillow's adaptive per-row filter choice)."""
    rng = np.random.default_rng({"noise": 1, "smooth": 2, "ramps": 3}[kind])
    if kind == "noise":
        depth = rng.integers(0, 65535, (64, 128))
    elif kind == "smooth":
        depth = np.cumsum(np.cumsum(rng.integers(-2, 3, (64, 128)), 0), 1) % 60000
    else:
        depth = np.add.outer(np.arange(64) * 37, np.arange(128) * 11) + 500
    depth = depth.astype(np.uint16)
    path = tmp_path / "d.depth.png"
    imageio.imwrite(str(path), depth)
    got = bev_pair.load_depth_mm(str(path))
    np.testing.assert_array_equal(got, imageio.imread(path))
    np.testing.assert_array_equal(got, depth)
    assert got.dtype == np.uint16


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (4, 3, 2, 1, 0)])
def test_each_png_filter_reads_as_imageio_does(filters):
    """The writer's rows take each filter; imageio, the C shim and the plain
    unfilter read the same pixels."""
    depth = (np.cumsum(np.random.default_rng(4).integers(-300, 301, (33, 70)), 1) % 65535).astype(np.uint16)
    data = png.encode_png(depth, filters)
    assert set(_filter_types(data)) == set(filters)
    np.testing.assert_array_equal(imageio.imread(io.BytesIO(data)), depth)
    np.testing.assert_array_equal(png.decode_png_bytes(data), depth)
    np.testing.assert_array_equal(png.decode_png_bytes(data, plain=True), depth)


def test_png_formats_it_does_not_read_raise(tmp_path):
    depth = np.arange(12, dtype=np.uint16).reshape(3, 4)
    data = bytearray(png.encode_png(depth))
    ihdr = 8 + 8  # IHDR body: width, height, depth, colour, compression, filter, interlace
    interlaced = bytearray(data)
    interlaced[ihdr + 12] = 1
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png_bytes(bytes(interlaced))

    def with_header(**fields):
        body = bytearray(data[ihdr:ihdr + 13])
        for off, v in fields.items():
            body[{"depth": 8, "colour": 9, "interlace": 12}[off]] = v
        crc = struct.pack(">I", zlib.crc32(b"IHDR" + bytes(body)))
        return bytes(data[:ihdr]) + bytes(body) + crc + bytes(data[ihdr + 17:])

    with pytest.raises(ValueError, match="Adam7"):
        png.decode_png_bytes(with_header(interlace=1))
    with pytest.raises(ValueError, match="colour type 3"):
        png.decode_png_bytes(with_header(colour=3, depth=8))
    with pytest.raises(ValueError, match="colour type 2 at bit depth 16"):
        png.decode_png_bytes(with_header(colour=2))
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png_bytes(b"GIF89a" + bytes(20))
    (tmp_path / "x.bmp").write_bytes(b"BM" + bytes(40))
    with pytest.raises(ValueError, match="neither a JPEG nor a PNG"):
        bev_pair.load_pano_rgb(str(tmp_path / "x.bmp"))


def test_jpeg_errors_raise_and_pano_rgb_matches_imageio_path():
    with pytest.raises(ValueError, match="JPEG"):
        jpeg.decode_jpeg_bytes(b"\xff\xd8\xff" + bytes(64))
    path = str(FIXTURES / "gray_31x47.jpg")
    gray = imageio.imread(path)
    want = bev_pair.bp.resize_pano_bilinear(torch.from_numpy(np.stack([gray] * 3, -1)), 512, 1024).numpy() / 255.0
    np.testing.assert_array_equal(bev_pair.load_pano_rgb(path), want)


# -- cli/test_fused.py end to end without imageio, PIL and cv2 -------------------

TINY = ["--num_layers", "18", "--resize_px", "64", "--crop_px", "56", "--batch_size", "2", "--device", "cpu"]
RUN = """
import importlib, json, sys
hidden, argv = json.loads(sys.argv[1]), json.loads(sys.argv[2])
sys.modules.update(dict.fromkeys(hidden))
if not hidden:
    import imageio.v2 as imageio
    import numpy as np
    from salve_tpu_torch.rendering import bev_pair
    def load_pano_rgb(p):
        rgb = imageio.imread(p)
        if rgb.ndim == 2:
            rgb = np.stack([rgb] * 3, axis=-1)
        return bev_pair.bp.resize_pano_bilinear(bev_pair.torch.from_numpy(np.asarray(rgb)), 512, 1024).numpy() / 255.0
    bev_pair.load_pano_rgb = load_pano_rgb
    bev_pair.load_depth_mm = lambda p: np.asarray(imageio.imread(p))
importlib.import_module("salve_tpu_torch.cli.test_fused").main(argv)
for name in hidden:
    assert sys.modules[name] is None, name
"""


@pytest.fixture(scope="module")
def synthetic_building(tmp_path_factory):
    """A procedural building's panos (JPEG) and depth cache (u16 PNG) from
    salve_tpu's materializer, a few hypotheses, and a tiny verifier."""
    from salve_tpu.dataset import procedural
    from salve_tpu.dataset.synthetic_zind import materialize_synthetic_building
    from salve_tpu_torch.models.early_fusion import EarlyFusionCEResnet

    root = tmp_path_factory.mktemp("fused_io")
    procedural.write_procedural_buildings(str(root / "zind"), ["9990"], base_seed=3)
    materialize_synthetic_building(str(root / "zind"), "9990", str(root / "raw"), depth_save_root=str(root / "depth"))
    stems = sorted(p.stem for p in (root / "raw" / "9990" / "panos").glob("*.jpg"))
    ids = [int(s.split("_")[-1]) for s in stems][:3]
    pos = root / "hyp" / "9990" / "floor_01" / "gt_alignment_approx"
    neg = root / "hyp" / "9990" / "floor_01" / "incorrect_alignment"
    pos.mkdir(parents=True)
    neg.mkdir(parents=True)
    Sim2.from_theta_deg(30.0, np.array([1.0, 0.5])).save_as_json(str(pos / f"{ids[0]}_{ids[1]}__door_0_1_identity.json"))
    Sim2.from_theta_deg(-45.0, np.array([0.0, 1.5])).save_as_json(str(neg / f"{ids[1]}_{ids[2]}__window_1_0_identity.json"))
    Sim2.from_theta_deg(120.0, np.array([-2.0, 0.0])).save_as_json(str(neg / f"{ids[0]}_{ids[2]}__door_0_0_rotated.json"))
    torch.manual_seed(0)
    ckpt = root / "tiny.pt"
    torch.save(EarlyFusionCEResnet(num_layers=18, compute_dtype="bfloat16").state_dict(), ckpt)
    return root, stems[:3]


def test_loaders_equal_imageio_on_the_synthetic_building(synthetic_building):
    root, stems = synthetic_building
    for stem in stems:
        pano = root / "raw" / "9990" / "panos" / f"{stem}.jpg"
        depth = root / "depth" / "9990" / f"{stem}.depth.png"
        np.testing.assert_array_equal(jpeg.decode_jpeg(pano), imageio.imread(pano))
        got = bev_pair.load_depth_mm(str(depth))
        assert got.shape == (512, 1024) and got.dtype == np.uint16
        np.testing.assert_array_equal(got, imageio.imread(depth))


def test_fused_cli_runs_without_imageio_pil_and_cv2(synthetic_building):
    root, _ = synthetic_building
    out = {}
    for tag, hidden in (("hidden", list(HIDDEN)), ("imageio", [])):
        argv = ["--hypotheses_save_root", str(root / "hyp"), "--raw_dataset_dir", str(root / "raw"),
                "--depth_save_root", str(root / "depth"), "--ckpt_fpath", str(root / "tiny.pt"),
                "--serialization_save_dir", str(root / f"preds_{tag}"), *TINY]
        proc = subprocess.run([sys.executable, "-c", RUN, json.dumps(hidden), json.dumps(argv)], cwd=REPO,
                              capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        files = sorted((root / f"preds_{tag}").glob("batch_*.json"))
        out[tag] = [json.loads(f.read_text()) for f in files]
    assert len(out["hidden"]) == 2
    assert out["hidden"] == out["imageio"]
    assert sum(len(b["y_hat"]) for b in out["hidden"]) == 3
