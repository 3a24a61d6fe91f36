"""The port's copies of salve_tpu's host modules, and its surface renders,
held against the originals.

Copies (Sim2, AlignmentHypothesis, TrainingConfig, the depth cache's hit
path, the BEV filename grammar, the synthetic pano generator of bench.py)
must equal the originals exactly. Eval preprocessing is float32 arithmetic
in the same order: within 1e-5. Surface renders go through sin/cos/atan2,
which may differ by an ulp between torch and XLA and move a round(), so they
are held to >= 99.9% equal u8 pixels and a max difference of 1.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from salve_tpu.common.alignment_hypothesis import AlignmentHypothesis as JaxHypothesis
from salve_tpu.depth import cache as jcache
from salve_tpu.geometry.sim2 import Sim2 as JaxSim2
from salve_tpu.ops.backproject import CEILING_Z_RANGE, FLOOR_Z_RANGE
from salve_tpu.rendering import bev_pair as jbev_pair
from salve_tpu.training import transforms as jtransforms
from salve_tpu.training.config import TrainingConfig as JaxConfig
from salve_tpu_torch.common.alignment_hypothesis import AlignmentHypothesis
from salve_tpu_torch.dataset.synthetic_bank import make_synthetic_pano_bank
from salve_tpu_torch.depth import cache
from salve_tpu_torch.geometry.sim2 import Sim2
from salve_tpu_torch.rendering import bev_pair
from salve_tpu_torch.training import transforms
from salve_tpu_torch.training.config import TrainingConfig
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("theta_deg", [0.0, 30.0, -135.0, 180.0])
def test_sim2_copy_matches_jax(theta_deg, tmp_path):
    t = np.array([1.25, -0.5])
    got, ref = Sim2.from_theta_deg(theta_deg, t, 1.5), JaxSim2.from_theta_deg(theta_deg, t, 1.5)
    for a, b in ((got.rotation, ref.rotation), (got.translation, ref.translation)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got.scale == ref.scale
    path = tmp_path / "h.json"
    ref.save_as_json(str(path))
    back = Sim2.from_json(str(path))
    np.testing.assert_array_equal(back.rotation, JaxSim2.from_json(str(path)).rotation)
    np.testing.assert_array_equal(back.translation, JaxSim2.from_json(str(path)).translation)


def test_record_and_config_copies_match_jax():
    assert AlignmentHypothesis._fields == JaxHypothesis._fields
    assert dataclasses.asdict(TrainingConfig()) == dataclasses.asdict(JaxConfig())
    assert bev_pair.BEVRenderConfig() == tuple(jbev_pair.BEVRenderConfig())
    assert bev_pair.HOHO_S_ZIND_SCALE_FACTOR == jbev_pair.HOHO_S_ZIND_SCALE_FACTOR
    np.testing.assert_array_equal(bev_pair._R_FIX, jbev_pair._R_FIX)
    args = (7, "door_0_1_identity", "floor", "/data/0999/panos/floor_01_partial_room_02_pano_2.jpg")
    assert bev_pair.bev_fname_from_img_fpath(*args) == jbev_pair.bev_fname_from_img_fpath(*args)


def test_synthetic_bank_is_the_bench_generator():
    got = make_synthetic_pano_bank(2, 32, 64)
    ref = bench.make_synthetic_pano_bank(2, 32, 64)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_depth_cache_hit_and_miss(tmp_path):
    img = "/data/0999/panos/floor_01_partial_room_02_pano_2.jpg"
    assert cache.depth_fpath_for_pano(str(tmp_path), "0999", img) == jcache.depth_fpath_for_pano(
        str(tmp_path), "0999", img)
    with pytest.raises(FileNotFoundError):
        cache.infer_depth_if_nonexistent(str(tmp_path), "0999", img)
    hit = tmp_path / "0999" / "floor_01_partial_room_02_pano_2.depth.png"
    hit.parent.mkdir()
    hit.write_bytes(b"")
    assert cache.infer_depth_if_nonexistent(str(tmp_path), "0999", img) == str(hit)


@pytest.mark.parametrize("src,dst", [((50, 50), (46, 46)), ((64, 64), (56, 56))])
def test_eval_preprocessing_matches_jax(src, dst):
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (2, 4) + src + (3,)).astype(np.float32)
    ref = np.asarray(jtransforms.preprocess_eval(jnp.asarray(imgs), *dst))
    got = transforms.preprocess_eval(torch.from_numpy(imgs), *dst).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    # The antialiased resize sums its filter taps in another order than
    # jax.image.resize: a few float32 ulps on [0, 255] values.
    ref = np.asarray(jtransforms.resize_batch(jnp.asarray(imgs), *dst))
    got = transforms.resize_batch(torch.from_numpy(imgs), *dst).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


def _assert_renders_close(got, ref):
    assert got.dtype == np.uint8 and got.shape == ref.shape
    assert (got == ref).mean() >= 0.999
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    assert (ref > 0).mean() > 0.05


@pytest.mark.parametrize("z_range", [FLOOR_Z_RANGE, CEILING_Z_RANGE], ids=["floor", "ceiling"])
def test_surface_renders_match_jax(z_range):
    rng = np.random.default_rng(6)
    depths = rng.uniform(1000, 4000, (2, 64, 128)).astype(np.uint16).astype(np.float32)
    rgbs = rng.uniform(0, 1, (2, 64, 128, 3)).astype(np.float32)
    th = np.deg2rad([25.0, -100.0])
    R = np.stack([np.stack([np.cos(th), -np.sin(th)], -1), np.stack([np.sin(th), np.cos(th)], -1)], 1)
    R = R.astype(np.float32)
    t = np.array([[0.5, -0.25], [-1.0, 0.75]], np.float32)
    cfg = dict(img_px=100, meters_per_px=0.1, crop_ratio=0.1)
    jcfg, tcfg = jbev_pair.BEVRenderConfig(**cfg), bev_pair.BEVRenderConfig(**cfg)
    d, c = torch.from_numpy(depths), torch.from_numpy(rgbs)

    ref = np.asarray(jbev_pair.render_identity_batched(jnp.asarray(depths), jnp.asarray(rgbs), z_range, jcfg))
    _assert_renders_close(bev_pair.render_identity_batched(d, c, z_range, tcfg).numpy(), ref)

    ref = np.asarray(jbev_pair.render_transformed_batched(
        jnp.asarray(depths), jnp.asarray(rgbs), jnp.asarray(R), jnp.asarray(t), z_range, jcfg))
    got = bev_pair.render_transformed_batched(d, c, torch.from_numpy(R), torch.from_numpy(t), z_range, tcfg)
    _assert_renders_close(got.numpy(), ref)
