"""The depth slice's host side against salve_tpu's, on the CPU.

Inputs are procedural floors (`dataset/procedural.py`) written as a ZInD
raw directory, their panos rendered by the synthetic raycaster and written
as JPEGs where a test reads images. Tolerances, each stated at its test:
  * (i) the numpy copy of rendering/synthetic.py and
    `synthesize_depth_from_layout` equal salve_tpu's bit for bit, on
    several seeds and layouts (every key of the cast, the textured RGB);
  * (vi) `iter_layout_depth_batches` yields salve_tpu's batches exactly
    and in order (synthetic, cached variants, and disk panos with cached
    depth); `evaluate_depth` equals salve_tpu's for one `predict_fn`
    within 1e-12 relative (float64 sums of the same terms), and is about 0
    for the oracle;
  * (vii) the cache miss with one numpy producer registered on both sides:
    salve_tpu's imageio reads the port's PNG as the array salve_tpu writes,
    exactly; a miss with no producer raises FileNotFoundError.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from salve_tpu.depth import cache as jcache
from salve_tpu.models import depth_net as jdn
from salve_tpu.rendering import synthetic as jsyn
from salve_tpu.training import depth as jdepth
from salve_tpu_torch.dataset.procedural import generate_building_json
from salve_tpu_torch.dataset.seeded_predictions import pano_image_paths
from salve_tpu_torch.depth import cache
from salve_tpu_torch.models import depth_net
from salve_tpu_torch.native import jpeg
from salve_tpu_torch.rendering import synthetic
from salve_tpu_torch.training import depth as tdepth
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

HW = (32, 64)
BIDS = ("0000", "0001")


def write_floors(root: Path, bids=BIDS, jpeg_hw=None) -> dict:
    """Procedural 1x2-room floors (seed = building ID) as a ZInD raw
    directory under `root`; with `jpeg_hw`, each pano also as a JPEG of
    that size, rendered by the synthetic raycaster from its own room.
    Returns building ID -> sorted pano image paths."""
    from salve_tpu_torch.common.posegraph2d import get_gt_pose_graph

    out = {}
    for bid in bids:
        building = generate_building_json(int(bid), n_rows=1, n_cols=2)
        (root / bid).mkdir(parents=True, exist_ok=True)
        (root / bid / "zind_data.json").write_text(json.dumps(building))
        paths = pano_image_paths(building)
        out[bid] = sorted(str(root / bid / p) for p in paths.values())
        if jpeg_hw is None:
            continue
        pg = get_gt_pose_graph(bid, "floor_01", str(root))
        for i, pano in pg.nodes.items():
            cam_h = pg.get_camera_height_m(i)
            verts = np.asarray(pano.room_vertices_local_2d, dtype=np.float64) * cam_h
            rgb = synthetic.render_synthetic_pano(verts, cam_h, h=jpeg_hw[0], w=jpeg_hw[1], seed=i)["rgb"]
            f = root / bid / paths[i]
            f.parent.mkdir(parents=True, exist_ok=True)
            jpeg.write_jpeg(f, rgb)
    return out


@pytest.fixture(scope="module")
def zind(tmp_path_factory):
    root = tmp_path_factory.mktemp("depth_zind")
    write_floors(root)
    return root


# ------------------------------------------------------------------ (i) the copies

RINGS = [
    np.array([[-2.0, -2.0], [2.0, -2.0], [2.0, 2.0], [-2.0, 2.0]]),
    np.array([[-1.5, -2.0], [2.5, -2.0], [2.5, 1.0], [0.5, 1.0], [0.5, 2.2], [-1.5, 2.2]]),
]


def test_ray_grid_equals_salve_tpus():
    from salve_tpu.geometry.pano_projection import get_uni_sphere_xyz

    for h, w in ((32, 64), (64, 128), (512, 1024)):
        np.testing.assert_array_equal(synthetic.uni_sphere_xyz_f64(h, w), get_uni_sphere_xyz(h, w))


@pytest.mark.parametrize("ring", range(len(RINGS)))
def test_raycast_and_synthesized_depth_equal_salve_tpus(ring):
    for cam_h, ceil_h in ((1.5, 3.0), (1.2, 2.9)):
        got = synthetic.raycast_layout(RINGS[ring], cam_h, ceil_h, h=64, w=128)
        ref = jsyn.raycast_layout(RINGS[ring], cam_h, ceil_h, h=64, w=128)
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        np.testing.assert_array_equal(depth_net.synthesize_depth_from_layout(RINGS[ring], cam_h, ceil_h, 64, 128),
                                      jdn.synthesize_depth_from_layout(RINGS[ring], cam_h, ceil_h, 64, 128))


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_render_synthetic_pano_equals_salve_tpus(seed):
    """Camera-anchored and world-anchored textures, with door mats."""
    world = dict(world_R=np.array([[0.6, -0.8], [0.8, 0.6]]), world_t=np.array([3.0, -1.5]),
                 door_rects=[((1.0, -2.0), (2.0, -2.0)), ((-1.5, 0.0), (-1.5, 1.0))])
    for kw in ({}, world):
        got = synthetic.render_synthetic_pano(RINGS[seed % 2], 1.4, h=64, w=128, seed=seed, **kw)
        ref = jsyn.render_synthetic_pano(RINGS[seed % 2], 1.4, h=64, w=128, seed=seed, **kw)
        assert sorted(got) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


# ------------------------------------------------------- (vi) batches and metrics


def _batches(mod, root, **kw):
    return list(mod.iter_layout_depth_batches(str(root), list(BIDS), 2, hw=HW, **kw))


@pytest.mark.parametrize("kw", [dict(synthetic_rgb=True, seed=3), dict(synthetic_rgb=True, seed=4, cache_variants=3)],
                         ids=["synthetic", "cached_variants"])
def test_layout_batches_equal_salve_tpus(zind, kw):
    got, ref = _batches(tdepth, zind, **kw), _batches(jdepth, zind, **kw)
    assert len(got) == len(ref) > 1
    for g, r in zip(got, ref):
        for a, b in zip(g, r):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_disk_batches_with_cached_depth_equal_salve_tpus(tmp_path):
    """Panos read from JPEGs, GT depth from a u16 PNG cache where one
    exists (the rest from the layout raycast)."""
    import imageio.v2 as imageio

    paths = write_floors(tmp_path / "zind", jpeg_hw=(64, 128))
    rng = np.random.default_rng(0)
    for bid, files in paths.items():
        (tmp_path / "depth" / bid).mkdir(parents=True)
        for f in files[::2]:
            imageio.imwrite(str(tmp_path / "depth" / bid / f"{Path(f).stem}.depth.png"),
                            rng.integers(100, 9000, (512, 1024), dtype=np.uint16))
    kw = dict(seed=1, depth_cache_root=str(tmp_path / "depth"))
    got = list(tdepth.iter_layout_depth_batches(str(tmp_path / "zind"), list(BIDS), 2, **kw))
    ref = list(jdepth.iter_layout_depth_batches(str(tmp_path / "zind"), list(BIDS), 2, **kw))
    assert len(got) == len(ref) > 1
    for g, r in zip(got, ref):
        for a, b in zip(g, r):
            np.testing.assert_array_equal(a, b)


def test_evaluate_depth_equals_salve_tpus_and_oracle_is_zero(zind):
    def predict(rgb):
        return 0.5 + 3.0 * rgb.mean(axis=-1)

    kw = dict(synthetic_rgb=True, hw=HW, max_panos=5)
    got = tdepth.evaluate_depth(predict, str(zind), list(BIDS), **kw)
    ref = jdepth.evaluate_depth(predict, str(zind), list(BIDS), **kw)
    assert sorted(got) == sorted(ref) and got["n_panos"] == ref["n_panos"] == 5
    for k in ("rmse_m", "abs_rel", "log10", "delta1"):
        assert got[k] == pytest.approx(ref[k], rel=1e-12), k

    examples = tdepth.collect_depth_examples(str(zind), list(BIDS))
    calls = iter(range(len(examples)))

    def oracle(rgb):
        _, pano, cam_h = examples[next(calls)]
        verts = np.asarray(pano.room_vertices_local_2d) * cam_h
        return depth_net.synthesize_depth_from_layout(verts, cam_h, 2 * cam_h, h=HW[0], w=HW[1])

    m = tdepth.evaluate_depth(oracle, str(zind), list(BIDS), synthetic_rgb=True, hw=HW, max_panos=3)
    assert m["rmse_m"] < 1e-6 and m["abs_rel"] < 1e-7 and m["delta1"] == 1.0


# ------------------------------------------------------------------ (vii) the cache


@pytest.fixture
def no_producer():
    yield
    cache.register_depth_model(None)
    jcache.register_depth_model(None)


def test_cache_miss_writes_salve_tpus_array(tmp_path, no_producer):
    import imageio.v2 as imageio

    paths = write_floors(tmp_path / "zind", bids=("0000",), jpeg_hw=(64, 128))
    img = paths["0000"][0]
    with pytest.raises(FileNotFoundError):
        cache.infer_depth_if_nonexistent(str(tmp_path / "port"), "0000", img)

    def producer(rgb):
        # Spans the clip at both ends and half-millimetre ties.
        return (np.linspace(-1.0, 70.0, rgb.shape[0])[:, None] + rgb[..., 0] * 0.01
                + np.linspace(0, 0.0005, rgb.shape[1])[None])

    cache.register_depth_model(producer)
    jcache.register_depth_model(producer)
    got = cache.infer_depth_if_nonexistent(str(tmp_path / "port"), "0000", img)
    ref = jcache.infer_depth_if_nonexistent(str(tmp_path / "ref"), "0000", img)
    assert Path(got).relative_to(tmp_path / "port") == Path(ref).relative_to(tmp_path / "ref")
    a, b = imageio.imread(got), imageio.imread(ref)
    assert a.dtype == b.dtype == np.uint16 and a.shape == (512, 1024)
    assert a.min() == 0 and a.max() == 65535
    np.testing.assert_array_equal(a, b)
    # A hit returns the path and runs nothing.
    cache.register_depth_model(lambda rgb: 1 / 0)
    assert cache.infer_depth_if_nonexistent(str(tmp_path / "port"), "0000", img) == got
    cache.register_depth_model(lambda rgb: np.zeros((256, 512)))
    with pytest.raises(ValueError, match="shape"):
        cache.infer_depth_if_nonexistent(str(tmp_path / "port"), "0000", paths["0000"][1])
