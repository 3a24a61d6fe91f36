"""The port's HoHoNet, its resize and the batch inference CLI against
salve_tpu's, on the CPU.

Weights are seeded (`models/hohonet.py:seeded_hohonet`) in the torch key
layout; they reach salve_tpu through its own `convert_hohonet_state_dict`,
which is strict both ways (every tensor consumed, every parameter filled).
Tolerances:
  * (ii) HoHoNet at 128x256, float32: the port's forward within 1e-5 m of
    salve_tpu's jitted forward (measured about 1e-7 on depths near 2.5 m);
  * (iv) `resize_linear` against `jax.image.resize(..., "linear")`
    (antialiased when shrinking), 2x down, up, and uneven both ways: within
    1e-6 on values in [0, 1] (the same weights, other summation orders;
    measured 3e-7);
  * (viii) `batch_hohonet_inference` with a `.pth` at --hohonet_input_hw
    128,256 over a floor's JPEG panos, against salve_tpu's CLI: one PNG a
    pano on each side, the same names, the u16 maps equal except on at most
    0.1% of the pixels, and those 1 mm apart (a float32 depth within 1e-6
    of a half millimetre can round either way).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from salve_tpu.depth import cache as jcache
from salve_tpu.models import hohonet as jh
from salve_tpu_torch.depth import cache
from salve_tpu_torch.models import hohonet as th
from salve_tpu_torch.native import png
from test_torch_depth_synthetic import write_floors
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

HW = (128, 256)


@pytest.fixture(scope="module")
def seeded():
    model = th.seeded_hohonet(HW, seed=0)
    params, stats = jh.convert_hohonet_state_dict(model.state_dict())
    return model, params, stats


def test_state_dict_is_the_converters_layout(seeded):
    """The port's keys are exactly what convert_hohonet_state_dict consumes,
    and its inverse carries the Flax tree back bit for bit."""
    from salve_tpu_torch.models.weights import hohonet_state_dict_from_flax

    model, params, stats = seeded
    sd = model.state_dict()
    back = hohonet_state_dict_from_flax(params, stats)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy().astype(back[k].numpy().dtype), err_msg=k)
    extra = dict(sd)
    extra["backbone.extra.weight"] = torch.zeros(1)
    with pytest.raises(ValueError, match="unconverted"):
        jh.convert_hohonet_state_dict(extra)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        th.HoHoNetDepth(HW).load_state_dict(extra, strict=True)


def test_forward_matches_salve_tpu(seeded):
    model, params, stats = seeded
    rgb = np.random.default_rng(0).uniform(0, 1, (1, *HW, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda x: jh.HoHoNetDepth(input_hw=HW).apply(
        {"params": params, "batch_stats": stats}, x))(jnp.asarray(rgb)))
    with torch.no_grad():
        got = model(torch.from_numpy(rgb)).numpy()
    assert got.shape == ref.shape == (1, *HW)
    assert 1.0 < ref.min() and ref.max() < 5.0
    assert np.abs(got - ref).max() <= 1e-5


def test_width_interp_equals_salve_tpus():
    x = np.random.default_rng(1).normal(size=(2, 13, 5)).astype(np.float32)
    for out_w in (13, 32, 7, 52):
        np.testing.assert_allclose(th._interp_width_linear(torch.from_numpy(x), out_w).numpy(),
                                   np.asarray(jh._interp_width_linear(jnp.asarray(x), out_w)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("shapes", [((128, 256), (64, 128)), ((64, 128), (128, 256)), ((100, 200), (64, 128)),
                                    ((64, 128), (97, 201)), ((64, 128), (64, 80))],
                         ids=["down2x", "up2x", "down_uneven", "up_uneven", "width_only"])
def test_resize_linear_equals_jax_image_resize(shapes):
    (h, w), (oh, ow) = shapes
    x = np.random.default_rng(2).uniform(0, 1, (h, w, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda a: jax.image.resize(a, (oh, ow, 3), method="linear"))(jnp.asarray(x)))
    got = th.resize_linear(torch.from_numpy(x), (oh, ow)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    ref2 = np.asarray(jax.jit(lambda a: jax.image.resize(a, (oh, ow), method="linear"))(jnp.asarray(x[..., 1])))
    np.testing.assert_allclose(th.resize_linear(torch.from_numpy(x[..., 1]), (oh, ow)).numpy(), ref2, rtol=0,
                               atol=1e-6)


def test_batch_inference_cli_matches_salve_tpus(seeded, tmp_path):
    from salve_tpu.cli.batch_hohonet_inference import run_batch_hohonet_inference as jax_cli
    from salve_tpu_torch.cli import batch_hohonet_inference

    paths = write_floors(tmp_path / "zind", bids=("0000",), jpeg_hw=(256, 512))
    ckpt = tmp_path / "ep60.pth"
    torch.save({"state_dict": seeded[0].state_dict()}, ckpt)
    common = ["--raw_dataset_dir", str(tmp_path / "zind"), "--building_id", "0000", "--model_ckpt", str(ckpt),
              "--hohonet_input_hw", "128,256", "--num_processes", "4"]
    try:
        jax_cli.main(common + ["--depth_save_root", str(tmp_path / "ref")], standalone_mode=False)
    finally:
        jcache.register_depth_model(None)
    assert batch_hohonet_inference.main(common + ["--depth_save_root", str(tmp_path / "port"), "--device", "cpu"]) \
        == (len(paths["0000"]), 0)
    assert cache._DEPTH_MODEL is None
    got = sorted(p.name for p in (tmp_path / "port" / "0000").iterdir())
    assert got == sorted(p.name for p in (tmp_path / "ref" / "0000").iterdir())
    assert len(got) == len(paths["0000"]) > 1
    off, n = 0, 0
    for name in got:
        a = png.read_png(tmp_path / "port" / "0000" / name).astype(np.int64)
        b = png.read_png(tmp_path / "ref" / "0000" / name).astype(np.int64)
        assert a.shape == b.shape == (512, 1024)
        assert 1000 < b.min() and b.max() < 5000
        assert np.abs(a - b).max() <= 1, name
        off += int((a != b).sum())
        n += a.size
    assert off <= 1e-3 * n, off
    # A second run finds every map cached and runs nothing.
    assert batch_hohonet_inference.main(["--raw_dataset_dir", str(tmp_path / "zind"), "--building_id", "0000",
                                         "--depth_save_root", str(tmp_path / "port"), "--device", "cpu"]) \
        == (len(paths["0000"]), 0)


def test_batch_inference_without_a_model_reports_missing(tmp_path, capsys):
    from salve_tpu_torch.cli import batch_hohonet_inference

    paths = write_floors(tmp_path / "zind", bids=("0001",), jpeg_hw=(32, 64))
    assert batch_hohonet_inference.main(["--raw_dataset_dir", str(tmp_path / "zind"), "--building_id", "0001",
                                         "--depth_save_root", str(tmp_path / "d"), "--device", "cpu"]) \
        == (0, len(paths["0001"]))
    assert f"Depth maps ready: 0, missing: {len(paths['0001'])}" in capsys.readouterr().out
