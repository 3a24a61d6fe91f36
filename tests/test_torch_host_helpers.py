"""The port's host helpers against salve_tpu's, cv2's and JAX's outputs.

  * `utils/{csv_utils,datetime_utils,logger_utils,function_timeout,mesh_grid,
    normalization_utils}.py`: equal results on the same inputs (the clock
    frozen for the datetime strings); `timeout` raises TimeoutError with its
    message, and lets a quick block finish;
  * `utils/transform.py`: every one of the 23 tuple transforms and both
    `get_imagenet_transform_lists` chains, from one seeded `random` state
    on each side, equal to salve_tpu's (which calls cv2) on uint8 images
    (byte for byte: the resize of a uint8 image equals cv2's) and on float32
    images within the float resize's bound below;
  * `resize_linear` against cv2 5.0.0's `resize(INTER_LINEAR)`: uint8 byte
    for byte, float32 within 2^-15 (2 ulps at 255: cv2 takes IPP's float
    path, whose rounding is its own), on upscales, downscales, integer and
    non-integer ratios, 1- and 3-channel images and 2-D images; `pad_image`
    against `cv2.copyMakeBorder(BORDER_CONSTANT)` byte for byte;
  * `ops/backproject.py:resize_pano_nearest` equal to `jax.image.resize(...,
    "nearest")` on upscales and downscales, integer and not.
"""

import datetime as _datetime
import random
import signal
import time

import cv2
import jax
import numpy as np
import pytest
import torch

from salve_tpu.ops.backproject import resize_pano_nearest as jax_resize_pano_nearest
from salve_tpu.utils import csv_utils as j_csv
from salve_tpu.utils import datetime_utils as j_dt
from salve_tpu.utils import logger_utils as j_log
from salve_tpu.utils import mesh_grid as j_grid
from salve_tpu.utils import normalization_utils as j_norm
from salve_tpu.utils import transform as j_tf
from salve_tpu_torch.ops.backproject import resize_pano_nearest
from salve_tpu_torch.utils import csv_utils, datetime_utils, function_timeout, logger_utils, mesh_grid
from salve_tpu_torch.utils import normalization_utils, transform
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CV2_VERSION = "5.0.0"  # the bytes below are this cv2's
MEAN, STD = normalization_utils.get_imagenet_mean_std()


def test_cv2_is_the_version_the_bounds_were_taken_on():
    assert cv2.__version__ == CV2_VERSION


# ---------------------------------------------------------------- small helpers


@pytest.mark.parametrize("delimiter,suffix", [(",", "csv"), ("\t", "tsv")])
def test_read_csv_equals_salve_tpu(tmp_path, delimiter, suffix):
    f = tmp_path / f"rows.{suffix}"
    f.write_text(delimiter.join(["building", "floor", "angle"]) + "\n"
                 + "\n".join(delimiter.join([f"{i:04d}", "floor_01", f"{0.5 * i}"]) for i in range(5)) + "\n")
    assert csv_utils.read_csv(str(f), delimiter) == j_csv.read_csv(str(f), delimiter)
    assert csv_utils.read_csv(str(f), delimiter)[2] == {"building": "0002", "floor": "floor_01", "angle": "1.0"}


class _FrozenClock:
    class datetime:
        @staticmethod
        def now():
            return _datetime.datetime(2021, 3, 4, 5, 6, 7)


def test_datetime_and_file_logger_paths_equal_salve_tpu(monkeypatch, tmp_path):
    monkeypatch.setattr(datetime_utils, "datetime", _FrozenClock)
    monkeypatch.setattr(j_dt, "datetime", _FrozenClock)
    assert datetime_utils.generate_datetime_string() == j_dt.generate_datetime_string() == "2021_03_04_05_06_07"
    monkeypatch.setattr(logger_utils, "generate_datetime_string", datetime_utils.generate_datetime_string)
    monkeypatch.setattr(j_log, "generate_datetime_string", j_dt.generate_datetime_string)
    # basicConfig is left alone where the root logger has handlers already.
    monkeypatch.setattr("logging.basicConfig", lambda **kwargs: None)
    got = logger_utils.setup_file_logger(str(tmp_path), "prog")
    assert got == j_log.setup_file_logger(str(tmp_path), "prog") == f"{tmp_path}/logging/prog_2021_03_04_05_06_07.log"
    assert (tmp_path / "logging").is_dir()


def test_get_logger_equals_salve_tpu():
    ours, theirs = logger_utils.get_logger(), j_log.get_logger()
    assert ours is theirs  # one "main-logger", configured once
    assert ours.name == "main-logger" and ours.level == 20 and len(ours.handlers) == 1


def test_function_timeout_raises_and_lets_quick_blocks_finish():
    with pytest.raises(TimeoutError, match="too slow"):
        with function_timeout.timeout(1, "too slow"):
            time.sleep(3)
    with function_timeout.timeout(1):
        done = True
    assert done and signal.alarm(0) == 0  # the alarm was cancelled on exit


@pytest.mark.parametrize("args", [(0, 10, 0, 5, 1.0), (-3, 4, 2, 9, 2.0), (0, 100, 0, 50, 3.5)])
def test_mesh_grid_equals_salve_tpu(args):
    np.testing.assert_array_equal(mesh_grid.get_mesh_grid_as_point_cloud(*args),
                                  j_grid.get_mesh_grid_as_point_cloud(*args))


def test_normalization_equals_salve_tpu():
    assert normalization_utils.get_imagenet_mean_std() == j_norm.get_imagenet_mean_std()
    img = np.random.default_rng(0).uniform(0, 255, (4, 5, 3))
    for std in (None, STD):
        np.testing.assert_array_equal(normalization_utils.normalize_img(img, MEAN, std),
                                      j_norm.normalize_img(img, MEAN, std))


# ---------------------------------------------------------------- resize and pad against cv2

SHAPES = [(7, 9), (16, 16), (37, 53), (234, 234), (100, 80), (2, 5)]


def _sizes(h, w):
    """Down and up, integer ratios and not, and the same size."""
    return [(3, 5), (14, 29), (224, 224), (50, 40), (2 * h, 2 * w), (max(h // 2, 1), max(w // 2, 1)), (h, w)]


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("channels", [0, 1, 3], ids=["2d", "1ch", "3ch"])
def test_resize_linear_equals_cv2(h, w, channels):
    rng = np.random.default_rng(h * 1000 + w + channels)
    shape = (h, w) if channels == 0 else (h, w, channels)
    u8 = rng.integers(0, 256, shape).astype(np.uint8)
    f32 = rng.uniform(0, 255, shape).astype(np.float32)
    for oh, ow in _sizes(h, w):
        ref = cv2.resize(u8, (ow, oh), interpolation=cv2.INTER_LINEAR)
        got = transform.resize_linear(u8, (oh, ow))
        assert got.dtype == np.uint8 and got.shape == ref.shape and np.array_equal(got, ref), (oh, ow)
        ref = cv2.resize(f32, (ow, oh), interpolation=cv2.INTER_LINEAR)
        got = transform.resize_linear(f32, (oh, ow))
        assert got.dtype == np.float32 and got.shape == ref.shape, (oh, ow)
        assert float(np.abs(got - ref).max()) <= 2.0 ** -15, (oh, ow)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("channels", [0, 3])
def test_pad_image_equals_cv2(dtype, channels):
    rng = np.random.default_rng(channels)
    shape = (5, 7) if channels == 0 else (5, 7, channels)
    img = (rng.uniform(0, 255, shape)).astype(dtype)
    for pad_h, pad_w in ((3, 2), (0, 4), (6, 0)):
        ref = cv2.copyMakeBorder(img, 0, pad_h, 0, pad_w, cv2.BORDER_CONSTANT, value=MEAN)
        got = transform.pad_image(img, pad_h, pad_w, MEAN)
        assert got.dtype == ref.dtype and got.shape == ref.shape and np.array_equal(got, ref)


# ---------------------------------------------------------------- the 23 tuple transforms

N_IMGS = {"Pair": 2, "Quadruplet": 4, "Sextuplet": 6}
ARITIES = list(N_IMGS)


def _imgs(n, dtype, h=23, w=31, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return tuple(rng.integers(0, 256, (h, w, 3)).astype(np.uint8) for _ in range(n))
    return tuple(rng.uniform(0, 255, (h, w, 3)).astype(np.float32) for _ in range(n))


def _assert_outputs(got, ref, exact):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        if exact:
            np.testing.assert_array_equal(g, r)
        else:
            assert float(np.abs(g.astype(np.float64) - r).max()) <= 2.0 ** -15


def _both(make, imgs, seed):
    """Each side's transform on the same images from the same `random` state."""
    out = []
    for module in (transform, j_tf):
        random.seed(seed)
        out.append(make(module)(*imgs))
    return out


def _transforms(arity):
    return {
        "Compose": lambda m: getattr(m, f"Compose{arity}")([getattr(m, f"Resize{arity}")((17, 19)),
                                                             getattr(m, f"ToTensor{arity}")()]),
        "ToTensor": lambda m: getattr(m, f"ToTensor{arity}")(),
        "Resize": lambda m: getattr(m, f"Resize{arity}")((40, 12)),
        "Crop_center": lambda m: getattr(m, f"Crop{arity}")((30, 20), crop_type="center", padding=MEAN),
        "Crop_rand": lambda m: getattr(m, f"Crop{arity}")((15, 40), crop_type="rand", padding=MEAN),
        "RandomHorizontalFlip": lambda m: getattr(m, f"RandomHorizontalFlip{arity}")(),
        "RandomVerticalFlip": lambda m: getattr(m, f"RandomVerticalFlip{arity}")(),
    }


@pytest.mark.parametrize("arity", ARITIES)
@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["u8", "f32"])
def test_tuple_transforms_equal_salve_tpu(arity, dtype):
    imgs = _imgs(N_IMGS[arity], dtype)
    exact = dtype == np.uint8
    for name, make in _transforms(arity).items():
        for seed in range(4):
            got, ref = _both(make, imgs, seed)
            # Compose's float resize runs before ToTensor: the float bound.
            _assert_outputs(got, ref, exact or name not in ("Compose", "Resize"))
    # Normalize on CHW float arrays, with and without std.
    chw = transform.ToTensorPair()(*imgs[:2])
    for std in (None, STD):
        _assert_outputs(getattr(transform, f"Normalize{arity}")(MEAN, std)(*(chw * (N_IMGS[arity] // 2))),
                        getattr(j_tf, f"Normalize{arity}")(MEAN, std)(*(chw * (N_IMGS[arity] // 2))), True)
    with pytest.raises(ValueError, match="expects"):
        getattr(transform, f"ToTensor{arity}")()(*imgs[:1])


def test_photometric_shift_and_aliases_equal_salve_tpu():
    imgs = _imgs(4, np.uint8)
    for jitter in (["brightness", "contrast", "saturation", "hue"], ["hue"], ["brightness"]):
        for seed in range(3):
            got, ref = _both(lambda m: m.PhotometricShiftQuadruplet(jitter), imgs, seed)
            _assert_outputs(got, ref, True)
    assert transform.PhotometricShift is transform.PhotometricShiftQuadruplet
    assert transform.RandomHorizontalFlipSextuuplet is transform.RandomHorizontalFlipSextuplet
    names = [n for n in dir(j_tf) if n[0].isupper() and isinstance(getattr(j_tf, n), type)]
    # 7 kinds x 3 arities, the photometric shift and the crop base.
    assert len([n for n in names if n not in ("PhotometricShift", "RandomHorizontalFlipSextuuplet")]) == 23
    assert all(hasattr(transform, n) for n in names)


@pytest.mark.parametrize("which", [0, 1], ids=["train", "eval"])
def test_imagenet_transform_lists_equal_salve_tpu(which):
    imgs = _imgs(4, np.uint8, h=200, w=260, seed=4)
    for seed in range(3):
        got, ref = _both(lambda m: m.get_imagenet_transform_lists()[which], imgs, seed)
        _assert_outputs(got, ref, True)
        assert got[0].shape == (3, 224, 224)
    small = _imgs(4, np.uint8, h=100, w=120, seed=5)  # Resize to 234 first, so no padding is needed
    got, ref = _both(lambda m: m.get_imagenet_transform_lists()[which], small, 0)
    _assert_outputs(got, ref, True)


# ---------------------------------------------------------------- resize_pano_nearest


@pytest.mark.parametrize("src", [(512, 1024), (37, 53)])
def test_resize_pano_nearest_equals_jax(src):
    rng = np.random.default_rng(src[0])
    img = rng.integers(0, 50, src + (3,)).astype(np.uint8)
    labels = rng.integers(0, 50, src).astype(np.int32)
    h, w = src
    for out in [(256, 512), (1024, 2048), (333, 777), (h * 3, w // 2 + 1), (1, 1)]:
        for x in (img, labels):
            ref = np.asarray(jax_resize_pano_nearest(jax.numpy.asarray(x), *out))
            got = resize_pano_nearest(torch.from_numpy(x), *out)
            assert got.dtype == torch.from_numpy(x).dtype
            np.testing.assert_array_equal(got.numpy(), ref)
