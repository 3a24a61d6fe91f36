"""The port's training data path against salve_tpu's, on the CPU.

  * augmentation: with the parameters JAX draws fed in, `apply_augment` is
    bit-exact with photometric jitter off, within 1e-3 on the 0-255 scale
    with it on; `preprocess_eval` is bit-exact;
  * the dataset: tuples, labels, order and batches equal `make_dataset` and
    `iter_batches` for every modality set, with `split_overrides`, salve_tpu
    given a sorted directory listing (`listing_sorted_make_dataset`): it
    takes `glob`'s order, the port sorts; the port's order is the same
    whatever order the listing comes in;
  * pixels: `decode_resize_batch` equals native/jpeg_loader.cpp (libjpeg,
    its float bilinear resize, np.clip(np.round(x)) to u8) byte for byte,
    the reference built into tmp_path with its own g++ line;
  * the device corpus: batch order, labels and `valid` equal salve_tpu's
    DeviceCorpus on a mesh of one device.

BEV trees are written with the port's JPEG encoder (`write_bev_tree`,
shared with tests/test_torch_training.py).
"""

import ctypes
import glob
import shutil
import subprocess
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salve_tpu.dataset import bev_pairs as jbp
from salve_tpu.parallel.mesh import make_mesh
from salve_tpu.training import device_corpus as jdc
from salve_tpu.training import transforms as jt
from salve_tpu.training.config import TrainingConfig as JaxConfig
from salve_tpu_torch.dataset import bev_pairs as tbp
from salve_tpu_torch.dataset.zind_partition import DATASET_SPLITS
from salve_tpu_torch.native import jpeg
from salve_tpu_torch.training import device_corpus as tdc
from salve_tpu_torch.training import transforms as tt
from salve_tpu_torch.training.config import TrainingConfig
from torch_parallel_work import FakeDataset
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
TRAIN_IDS = sorted(DATASET_SPLITS["train"], key=int)[:2]
VAL_ID = sorted(DATASET_SPLITS["val"], key=int)[0]
TEST_ID = sorted(DATASET_SPLITS["test"], key=int)[0]
MODALITY_SETS = [
    ("layout",),
    ("ceiling_rgb_texture",),
    ("floor_rgb_texture",),
    ("ceiling_rgb_texture", "floor_rgb_texture"),
    ("ceiling_rgb_texture", "floor_rgb_texture", "layout"),
]


_GLOB = glob.glob


def listing_sorted(fn):
    """`fn` run on sorted directory listings. salve_tpu reads a floor's
    rendered files (`make_dataset`) and the `batch_*.json` predictions
    (`edge_classification`) in `glob`'s order, which follows the filesystem;
    the port sorts them. Tests that hold the port's order to salve_tpu's
    run salve_tpu's function through this."""

    def sorted_listing(*args, **kwargs):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(glob, "glob", lambda pattern, **kw: sorted(_GLOB(pattern, **kw)))
            return fn(*args, **kwargs)

    return sorted_listing


listing_sorted_make_dataset = listing_sorted(jbp.make_dataset)


def _fname(pair: int, surface: str, floor: str, pano: int) -> str:
    return f"pair_{pair}___door_0_0_identity_{surface}_rgb_{floor}_partial_room_01_pano_{pano}.jpg"


def write_bev_tree(root: Path, pairs: dict, px: int = 40, seed: int = 0, layout_root: Path = None) -> Path:
    """A rendered-BEV tree: for each {building: n_pairs}, both labels, pairs
    on floor_01 (and pair 0 also on floor_00), ceiling and floor images of
    two panos each, written by the port's encoder (q95). Positives are
    brighter than negatives. Each floor also holds one incomplete pair (3
    files), which the loader skips. With `layout_root`, a layout image beside
    every floor image (same name)."""
    rng = np.random.default_rng(seed)
    for label, base in (("gt_alignment_approx", 150), ("incorrect_alignment", 60)):
        for bid, n_pairs in pairs.items():
            for floor in ("floor_00", "floor_01"):
                d = root / label / bid
                d.mkdir(parents=True, exist_ok=True)
                n = n_pairs if floor == "floor_01" else 1
                for pair in list(range(n)) + [n_pairs + 7]:
                    for surface in ("ceiling", "floor"):
                        for pano in (2 * pair + 1, 2 * pair + 2):
                            if pair == n_pairs + 7 and surface == "floor" and pano % 2 == 0:
                                continue  # the incomplete pair
                            img = np.clip(rng.normal(base, 40, (px, px, 3)), 0, 255).astype(np.uint8)
                            jpeg.write_jpeg(d / _fname(pair, surface, floor, pano), img)
                            if layout_root is not None and surface == "floor":
                                (layout_root / label / bid).mkdir(parents=True, exist_ok=True)
                                lay = np.clip(rng.normal(255 - base, 30, (px, px, 3)), 0, 255).astype(np.uint8)
                                jpeg.write_jpeg(layout_root / label / bid / _fname(pair, surface, floor, pano), lay)
    return root


@pytest.fixture(scope="module")
def bev_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("bev")
    pairs = {TRAIN_IDS[0]: 3, TRAIN_IDS[1]: 2, VAL_ID: 2, TEST_ID: 1}
    write_bev_tree(root / "tex", pairs, layout_root=root / "layout")
    return root


def _configs(bev_tree, modalities, **kw):
    data_root = bev_tree / ("layout" if modalities == ("layout",) else "tex")
    args = dict(data_root=str(data_root), layout_data_root=str(bev_tree / "layout"), modalities=modalities,
                resize_h=24, resize_w=28)
    args.update(kw)
    return JaxConfig(**args), TrainingConfig(**args)


def _jax_aug_params(key, b, n, h, w, crop_h, crop_w, photometric):
    """The parameters salve_tpu's augment_train draws from `key`
    (transforms.py:109-146, photometric_shift :54-70)."""
    k_crop_h, k_crop_w, k_hflip, k_vflip, k_photo = jax.random.split(key, 5)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    photo = None
    if photometric:
        kb, kc, ks, kh = jax.random.split(k_photo, 4)
        draw = lambda k, lo, hi: t(jax.random.uniform(k, (b, n, 1, 1, 1), minval=lo, maxval=hi)).reshape(b, n)  # noqa: E731
        photo = tt.PhotometricParams(draw(kb, 0.5, 1.5), draw(kc, 0.5, 1.5), draw(ks, 0.5, 1.5),
                                     draw(kh, -0.05, 0.05))
    return tt.AugmentParams(
        off_h=t(jax.random.randint(k_crop_h, (b,), 0, h - crop_h + 1)).long(),
        off_w=t(jax.random.randint(k_crop_w, (b,), 0, w - crop_w + 1)).long(),
        do_hflip=t(jax.random.bernoulli(k_hflip, 0.5, (b,))),
        do_vflip=t(jax.random.bernoulli(k_vflip, 0.5, (b,))),
        photometric=photo,
    )


# ---------------------------------------------------------------- (b) augmentation


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augment_train_is_bit_exact_with_jax_parameters(seed):
    """Photometric off: crop and flips are index ops on u8, then the same
    normalize (a product with float32(1/std), as XLA rewrites the divide)."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (6, 4, 40, 44, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jt.augment_train(key, jnp.asarray(imgs), 32, 36, photometric=False))
    got = tt.apply_augment(torch.from_numpy(imgs), _jax_aug_params(key, 6, 4, 40, 44, 32, 36, False), 32, 36)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_photometric_augment_within_1e_3_of_jax():
    """Photometric on: within 1e-3 on the 0-255 scale. The difference is
    float32 rounding: XLA:CPU fuses the gray and YIQ weighted sums into
    FMAs and sums the per-image mean gray in its own order, and its cos/sin
    of the hue angle may differ from torch's by an ulp."""
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (5, 2, 30, 30, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(11)
    ref = np.asarray(jt.augment_train(key, jnp.asarray(imgs), 24, 24, photometric=True))
    got = tt.apply_augment(torch.from_numpy(imgs), _jax_aug_params(key, 5, 2, 30, 30, 24, 24, True), 24, 24).numpy()
    scale = np.array(tt.IMAGENET_STD, dtype=np.float64)
    assert np.abs((got.astype(np.float64) - ref) * scale).max() < 1e-3
    # The jitter alone (before crop, flips and normalize), same tolerance.
    p = _jax_aug_params(key, 5, 2, 30, 30, 24, 24, True)
    k_photo = jax.random.split(key, 5)[4]
    ref_photo = np.asarray(jt.photometric_shift(k_photo, jnp.asarray(imgs, jnp.float32)))
    got_photo = tt.photometric_shift(torch.from_numpy(imgs).float(), p.photometric).numpy()
    assert np.abs(got_photo - ref_photo).max() < 1e-3


def test_preprocess_eval_is_bit_exact():
    imgs = np.random.default_rng(3).integers(0, 256, (3, 4, 36, 40, 3), dtype=np.uint8)
    ref = np.asarray(jt.preprocess_eval(jnp.asarray(imgs), 32, 32))
    np.testing.assert_array_equal(tt.preprocess_eval(torch.from_numpy(imgs), 32, 32).numpy(), ref)


def test_drawn_parameters_are_in_range_and_seeded():
    gen = torch.Generator().manual_seed(0)
    p = tt.draw_augment_params(gen, 64, 4, 40, 44, 32, 36, photometric=True)
    assert p.off_h.min() >= 0 and p.off_h.max() <= 8 and p.off_w.max() <= 8
    assert 0 < p.do_hflip.float().mean() < 1 and 0 < p.do_vflip.float().mean() < 1
    ph = p.photometric
    assert ph.brightness.shape == (64, 4) and 0.5 <= ph.brightness.min() and ph.brightness.max() <= 1.5
    assert -0.05 <= ph.hue.min() and ph.hue.max() <= 0.05
    imgs = torch.randint(0, 256, (64, 4, 40, 44, 3), dtype=torch.uint8)
    a = tt.augment_train(torch.Generator().manual_seed(9), imgs, 32, 36, photometric=True)
    b = tt.augment_train(torch.Generator().manual_seed(9), imgs, 32, 36, photometric=True)
    assert a.shape == (64, 4, 32, 36, 3) and torch.equal(a, b)


# ---------------------------------------------------------------- (c) the dataset


@pytest.mark.parametrize("modalities", MODALITY_SETS, ids=["+".join(m) for m in MODALITY_SETS])
def test_make_dataset_equals_salve_tpu(bev_tree, modalities, monkeypatch):
    jcfg, tcfg = _configs(bev_tree, modalities)
    overrides = {TRAIN_IDS[1]: "val", VAL_ID: "test"}
    for split in ("train", "val", "test"):
        ref = listing_sorted_make_dataset(split, jcfg.data_root, jcfg)
        got = tbp.make_dataset(split, tcfg.data_root, tcfg)
        assert got == ref and len(got) > 0, split
        ref = listing_sorted_make_dataset(split, jcfg.data_root, replace(jcfg, split_overrides=overrides))
        got = tbp.make_dataset(split, tcfg.data_root, replace(tcfg, split_overrides=overrides))
        assert got == ref and len(got) > 0, (split, overrides)
    n_imgs = len(got[0]) - 1
    assert n_imgs == {1: 2, 2: 4, 3: 6}[len(modalities)]
    # The port's order does not follow the listing's: reversed, it is the same.
    want = tbp.make_dataset("train", tcfg.data_root, tcfg)
    monkeypatch.setattr(tbp.glob, "glob", lambda pattern, **kw: sorted(_GLOB(pattern, **kw), reverse=True))
    assert tbp.make_dataset("train", tcfg.data_root, tcfg) == want


def test_filename_parsers_and_building_ids(bev_tree):
    for f in sorted((bev_tree / "tex" / "gt_alignment_approx" / TRAIN_IDS[0]).glob("*.jpg"))[:4]:
        assert tbp.pair_idx_from_fpath(str(f)) == jbp.pair_idx_from_fpath(str(f))
        assert tbp.pano_id_from_fpath(str(f)) == jbp.pano_id_from_fpath(str(f))
    root = str(bev_tree / "tex" / "gt_alignment_approx")
    assert tbp.get_available_building_ids(root) == jbp.get_available_building_ids(root)
    with pytest.raises(RuntimeError, match="does not exist"):
        tbp.make_dataset("train", str(bev_tree / "absent"), TrainingConfig())


@pytest.mark.parametrize("modalities", MODALITY_SETS[2:4], ids=["floor", "ceiling+floor"])
def test_iter_batches_equal_salve_tpu(bev_tree, modalities, monkeypatch):
    """Order, labels and tuples of every batch, shuffled and not, tail batch
    included; salve_tpu's images come from its own loader's
    arithmetic (the reference library built privately, see
    `_reference_loader`) or, without g++/libjpeg, are not compared here."""
    jcfg, tcfg = _configs(bev_tree, modalities)
    monkeypatch.setattr(jbp, "make_dataset", listing_sorted_make_dataset)
    jds = jbp.BEVPairDataset("train", jcfg, workers=2)
    tds = tbp.BEVPairDataset("train", tcfg, workers=2)
    ref_lib = _reference_loader_or_none(bev_tree)

    def reference_pixels(self, tuples):
        flat = [fp for t in tuples for fp in t[:-1]]
        if ref_lib is None:
            return np.zeros((len(tuples), len(tuples[0]) - 1, self.args.resize_h, self.args.resize_w, 3), np.uint8)
        imgs = _reference_decode(ref_lib, flat, self.args.resize_h, self.args.resize_w)
        return imgs.reshape(len(tuples), len(tuples[0]) - 1, self.args.resize_h, self.args.resize_w, 3)

    # salve_tpu's loader would build native/libjpeg_loader.so inside the
    # checkout (ROADMAP §C: concurrent workers race on it); its arithmetic
    # comes from the private build instead.
    monkeypatch.setattr(jbp.BEVPairDataset, "_load_tuples", reference_pixels)
    assert len(tds) == len(jds) > 4
    for kw in (dict(shuffle=False), dict(shuffle=True, seed=3), dict(shuffle=True, seed=4)):
        ref = list(jds.iter_batches(4, **kw))
        got = list(tds.iter_batches(4, **kw))
        assert len(got) == len(ref) > 1
        for (ri, rl, rt), (gi, gl, gt) in zip(ref, got):
            assert gt == rt
            np.testing.assert_array_equal(gl, rl)
            assert gi.dtype == np.uint8 and gi.shape == ri.shape
            if ref_lib is not None:
                np.testing.assert_array_equal(gi, ri)


def test_decoded_cache_serves_the_same_bytes(bev_tree):
    _, tcfg = _configs(bev_tree, MODALITY_SETS[3], decoded_cache_gb=1.0)
    cached = tbp.BEVPairDataset("train", tcfg, workers=2)
    plain = tbp.BEVPairDataset("train", replace(tcfg, decoded_cache_gb=0.0), workers=2)
    assert cached._cache == {} and plain._cache is None
    idx = [3, 0, 2]
    first, _, _ = cached.load_batch(idx)
    again, labels, tuples = cached.load_batch(idx[::-1])
    ref, ref_labels, _ = plain.load_batch(idx[::-1])
    assert sorted(cached._cache) == sorted(idx)
    np.testing.assert_array_equal(again, ref)
    np.testing.assert_array_equal(labels, ref_labels)
    np.testing.assert_array_equal(first[0], again[2])


# ---------------------------------------------------------------- (d) pixels


def _reference_loader_or_none(tmp: Path):
    """native/jpeg_loader.cpp built with salve_tpu/native/loader.py's g++
    line into a private directory (never native/libjpeg_loader.so, which
    xdist workers race on); None where g++ or libjpeg is missing."""
    if shutil.which("g++") is None:
        return None
    out = Path(tmp) / "ref_loader" / "libjpeg_loader.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        res = subprocess.run(["g++", "-O3", "-shared", "-fPIC", str(REPO / "native" / "jpeg_loader.cpp"),
                              "-ljpeg", "-lpthread", "-o", str(out)], capture_output=True, text=True)
        if res.returncode != 0:
            return None
    lib = ctypes.CDLL(str(out))
    lib.decode_resize_batch.restype = ctypes.c_int
    lib.decode_resize_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    return lib


def _reference_decode(lib, paths, out_h, out_w):
    """salve_tpu's native path: float32 resize, then np.clip(np.round(.)) to u8
    (salve_tpu/dataset/bev_pairs.py:202-218)."""
    n = len(paths)
    out = np.empty((n, out_h, out_w, 3), dtype=np.float32)
    ok = np.zeros(n, dtype=np.uint8)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    lib.decode_resize_batch(c_paths, n, out_h, out_w, out.ctypes.data, ok.ctypes.data, 2)
    assert ok.all()
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def reference_loader(tmp_path_factory):
    lib = _reference_loader_or_none(tmp_path_factory.mktemp("lib"))
    if lib is None:
        pytest.skip("g++ or libjpeg is missing: native/jpeg_loader.cpp does not build here")
    return lib


@pytest.mark.parametrize("out_hw", [(234, 234), (36, 36), (24, 28), (72, 40), (500, 700)])
def test_decode_resize_equals_native_loader(reference_loader, tmp_path, out_hw):
    """Byte for byte: the codec's decode, the float bilinear resize (built
    with -ffp-contract=off) and the half-to-even rounding, at down- and
    upsampling sizes, on 4:2:0 colour and grayscale files."""
    rng = np.random.default_rng(sum(out_hw))
    paths = []
    for i, (h, w) in enumerate([(501, 501), (64, 64), (37, 53), (100, 300), (17, 9)]):
        img = (rng.integers(0, 255, (h, w, 3)) // 3 * 3 + np.arange(w)[None, :, None] % 7).clip(0, 255)
        p = tmp_path / f"{i}.jpg"
        jpeg.write_jpeg(p, img.astype(np.uint8), quality=90 + i)
        paths.append(p)
    paths.append(REPO / "salve_tpu_torch" / "native" / "fixtures" / "gray_31x47.jpg")
    got = jpeg.decode_resize_batch(paths, *out_hw, num_threads=3)
    np.testing.assert_array_equal(got, _reference_decode(reference_loader, paths, *out_hw))


def test_dataset_pixels_equal_native_loader(reference_loader, bev_tree):
    _, tcfg = _configs(bev_tree, MODALITY_SETS[4], resize_h=36, resize_w=36)
    ds = tbp.BEVPairDataset("train", tcfg, workers=4)
    imgs, _, tuples = ds.load_batch(range(len(ds)))
    flat = [fp for t in tuples for fp in t[:-1]]
    ref = _reference_decode(reference_loader, flat, 36, 36).reshape(imgs.shape)
    np.testing.assert_array_equal(imgs, ref)


def test_decode_resize_raises_on_a_file_the_codec_refuses(tmp_path):
    good = tmp_path / "good.jpg"
    jpeg.write_jpeg(good, np.zeros((8, 8, 3), np.uint8))
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"\x89PNG\r\n\x1a\n" + bytes(32))
    with pytest.raises(ValueError, match="bad.jpg"):
        jpeg.decode_resize_batch([good, bad], 4, 4)
    with pytest.raises(ValueError, match="absent.jpg"):
        jpeg.decode_resize_batch([tmp_path / "absent.jpg"], 4, 4)
    assert jpeg.decode_resize_batch([], 4, 4).shape == (0, 4, 4, 3)


# ---------------------------------------------------------------- (e) the device corpus


@pytest.mark.parametrize("n,batch", [(50, 8), (16, 16), (1030, 64)])
def test_device_corpus_equals_salve_tpu_on_one_device(n, batch):
    small = dict(resize_h=6, resize_w=5)
    jds, tds = FakeDataset(JaxConfig(**small), n), FakeDataset(TrainingConfig(**small), n)
    assert tdc.estimated_corpus_bytes(tds) == jdc.estimated_corpus_bytes(jds) == n * 2 * 6 * 5 * 3
    ref = jdc.DeviceCorpus(jds, make_mesh((1,), devices=jax.devices()[:1]))
    got = tdc.DeviceCorpus(tds, torch.device("cpu"))
    assert got.corpus.dtype == torch.uint8 and tuple(got.corpus.shape) == (n, 2, 6, 5, 3)
    for shuffle, seed in ((True, 0), (True, 5), (False, 0)):
        rb = list(ref.iter_batches(batch, shuffle=shuffle, seed=seed))
        gb = list(got.iter_batches(batch, shuffle=shuffle, seed=seed))
        assert len(gb) == len(rb) == n // batch
        for (ri, rl, rt, rv), (gi, gl, gt, gv) in zip(rb, gb):
            assert gt == rt
            np.testing.assert_array_equal(gl, rl)
            np.testing.assert_array_equal(gv, rv)
            assert gv.all()
            np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))


def test_device_corpus_refuses_an_empty_or_too_small_split():
    args = TrainingConfig(resize_h=4, resize_w=4)
    with pytest.raises(ValueError, match="empty"):
        tdc.DeviceCorpus(FakeDataset(args, 0), torch.device("cpu"))
    with pytest.raises(ValueError, match="batch"):
        next(tdc.DeviceCorpus(FakeDataset(args, 3), torch.device("cpu")).iter_batches(4, shuffle=True))
