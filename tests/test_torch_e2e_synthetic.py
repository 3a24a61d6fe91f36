"""The floor world and the building materializer against salve_tpu's, on the CPU.

Input: one procedural building (`generate_building_json` on a 1x2 grid: two
rooms joined by a door, five panos) written as a ZInD directory.
Tolerances, each stated at its test:
  * `build_floor_world` gives salve_tpu's segments, portals and door spans;
    `raycast_floor_world` and `render_synthetic_pano_world` (door mats
    painted) equal salve_tpu's bit for bit for every pano, at 64x128 and
    512x1024; so does `synthetic_pano_for_pano_data`;
  * `materialize_synthetic_building` writes salve_tpu's tree:
    zind_data.json and every JPEG byte for byte, every depth PNG decoding
    to salve_tpu's u16 array; the resume contract (nothing rewritten; a
    missing artifact alone rewritten); the depth-provider branch with one
    numpy provider on both sides, from the ray cast and from an existing
    pano (decoded by the port's JPEG reader, Pillow's arrays), exactly;
    and `load_depth_provider` on a small salve_tpu msgpack filling one
    missing depth map with its own output.
"""

import hashlib
import json
import shutil
from pathlib import Path

import imageio.v2 as imageio
import numpy as np
import pytest

from salve_tpu.common import posegraph2d as jpg2
from salve_tpu.dataset import synthetic_zind as jsz
from salve_tpu.rendering import synthetic as jsyn
from salve_tpu_torch.common import posegraph2d as tpg2
from salve_tpu_torch.dataset import synthetic_zind as tsz
from salve_tpu_torch.dataset.procedural import generate_building_json
from salve_tpu_torch.native import jpeg, png
from salve_tpu_torch.rendering import synthetic as tsyn

BID = "0000"
FLOOR = "floor_01"


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    root = tmp_path_factory.mktemp("e2e_src")
    (root / BID).mkdir()
    (root / BID / "zind_data.json").write_text(json.dumps(generate_building_json(1, n_rows=1, n_cols=2)))
    raw = root / "raw"
    (raw / BID).mkdir(parents=True)
    shutil.copy(root / BID / "zind_data.json", raw / BID / "zind_data.json")
    return root


@pytest.fixture(scope="module")
def graphs(src):
    return (jpg2.get_gt_pose_graph(BID, FLOOR, str(src / "raw")),
            tpg2.get_gt_pose_graph(BID, FLOOR, str(src / "raw")))


def test_floor_world_equals_salve_tpus(graphs):
    ref, got = jsyn.build_floor_world(graphs[0]), tsyn.build_floor_world(graphs[1])
    assert len(ref.rooms) == len(got.rooms) == 5
    for a, b in zip(ref.rooms, got.rooms):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ref.seg_a, got.seg_a)
    np.testing.assert_array_equal(ref.seg_b, got.seg_b)
    assert ref.portals == got.portals and any(ref.portals)
    assert len(got.door_rects) == len(ref.door_rects) >= 1  # a door joins the two rooms
    for (a0, b0), (a1, b1) in zip(ref.door_rects, got.door_rects):
        np.testing.assert_array_equal(a0, a1)
        np.testing.assert_array_equal(b0, b1)


def _pano_args(pg, i):
    pano = pg.nodes[i]
    S = float(pg.scale_meters_per_coordinate)
    cam_xy = pano.global_Sim2_local.transform_from(np.zeros((1, 2)))[0] * S
    world_R = np.asarray(pano.global_Sim2_local.rotation, dtype=np.float64) @ jsyn.R_FIX
    return dict(cam_xy=cam_xy, cam_h=pg.get_camera_height_m(i), ceil_h=2.6, world_R=world_R)


@pytest.mark.parametrize("hw", [(64, 128), (512, 1024)])
def test_floor_world_renders_equal_salve_tpus(graphs, hw):
    """Every pano of the floor, world-anchored textures with door mats."""
    jpg, tpg = graphs
    jworld, tworld = jsyn.build_floor_world(jpg), tsyn.build_floor_world(tpg)
    mats = 0
    for i in jpg.nodes:
        kw = _pano_args(jpg, i)
        ref_cast = jsyn.raycast_floor_world(jworld, kw["cam_xy"], kw["cam_h"], kw["ceil_h"], kw["world_R"], *hw)
        got_cast = tsyn.raycast_floor_world(tworld, kw["cam_xy"], kw["cam_h"], kw["ceil_h"], kw["world_R"], *hw)
        assert sorted(ref_cast) == sorted(got_cast)
        for k in ref_cast:
            np.testing.assert_array_equal(got_cast[k], ref_cast[k], err_msg=k)
        ref = jsyn.render_synthetic_pano_world(jworld, h=hw[0], w=hw[1], seed=11, door_rects=jworld.door_rects, **kw)
        got = tsyn.render_synthetic_pano_world(tworld, h=hw[0], w=hw[1], seed=11, door_rects=tworld.door_rects, **kw)
        assert sorted(ref) == sorted(got)
        for k in ref:
            assert got[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        bare = tsyn.render_synthetic_pano_world(tworld, h=hw[0], w=hw[1], seed=11, door_rects=None, **kw)
        mats += int(not np.array_equal(bare["rgb"], got["rgb"]))
        assert (got["surface"] == tsyn.WALL).any() and (got["wall_seg"] >= 0).any()
    assert mats >= 1, "no pano sees a door mat"


def test_synthetic_pano_for_pano_data_equals_salve_tpus(graphs):
    jpg, tpg = graphs
    i = sorted(jpg.nodes)[0]
    cam_h = jpg.get_camera_height_m(i)
    ref = jsyn.synthetic_pano_for_pano_data(jpg.nodes[i], cam_h, seed=3,
                                            scale_meters_per_coordinate=jpg.scale_meters_per_coordinate)
    got = tsyn.synthetic_pano_for_pano_data(tpg.nodes[i], cam_h, seed=3,
                                            scale_meters_per_coordinate=tpg.scale_meters_per_coordinate)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


# ------------------------------------------------------------------ the materializer


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p for p in sorted(root.rglob("*")) if p.is_file()}


def _assert_trees_equal(ref_root: Path, got_root: Path) -> None:
    ref, got = _files(ref_root), _files(got_root)
    assert sorted(got) == sorted(ref)
    for name, p in ref.items():
        if name.endswith(".png"):
            want = imageio.imread(p)
            have = png.read_png(got[name])
            assert have.dtype == want.dtype == np.uint16, name
            np.testing.assert_array_equal(have, want, err_msg=name)
        else:
            assert got[name].read_bytes() == p.read_bytes(), name


def _sha(p: Path) -> str:
    return hashlib.sha256(p.read_bytes()).hexdigest()


@pytest.fixture(scope="module")
def materialized(src, tmp_path_factory):
    out = tmp_path_factory.mktemp("materialized")
    ref = jsz.materialize_synthetic_building(str(src), BID, str(out / "ref_raw"),
                                             depth_save_root=str(out / "ref_depth"))
    got = tsz.materialize_synthetic_building(str(src), BID, str(out / "raw"), depth_save_root=str(out / "depth"))
    return out, ref, got


def test_materialized_tree_equals_salve_tpus(materialized):
    out, ref, got = materialized
    assert got == ref == {FLOOR: 5}
    _assert_trees_equal(out / "ref_raw", out / "raw")
    _assert_trees_equal(out / "ref_depth", out / "depth")
    assert len(list((out / "raw" / BID / "panos").glob("*.jpg"))) == 5
    assert len(list((out / "depth" / BID).glob("*.depth.png"))) == 5
    assert sorted(tsz._ceiling_heights_by_stem(out / "raw" / BID / "zind_data.json").items()) == sorted(
        jsz._ceiling_heights_by_stem(out / "ref_raw" / BID / "zind_data.json").items())


def test_resume_rewrites_only_missing_artifacts(materialized, src, tmp_path):
    out = materialized[0]
    raw, depth = tmp_path / "raw", tmp_path / "depth"
    shutil.copytree(out / "raw", raw)
    shutil.copytree(out / "depth", depth)
    panos = sorted((raw / BID / "panos").glob("*.jpg"))
    maps = sorted((depth / BID).glob("*.depth.png"))
    for p in panos + maps:
        p.write_bytes(b"kept")  # an existing artifact is never rewritten
    panos[0].unlink()
    maps[1].unlink()
    assert tsz.materialize_synthetic_building(str(src), BID, str(raw), depth_save_root=str(depth)) == {FLOOR: 5}
    ref = out / "raw" / BID / "panos" / panos[0].name
    assert panos[0].read_bytes() == ref.read_bytes()
    np.testing.assert_array_equal(png.read_png(maps[1]), png.read_png(out / "depth" / BID / maps[1].name))
    assert all(p.read_bytes() == b"kept" for p in panos[1:] + maps[:1] + maps[2:])


def _provider(rgb: np.ndarray) -> np.ndarray:
    """A numpy depth provider: (H, W, 3) float32 in [0, 1] -> meters."""
    return (0.5 + 3.0 * rgb.mean(axis=-1) + 0.25 * rgb[..., 0] ** 2).astype(np.float32)


@pytest.mark.parametrize("existing_panos", [False, True])
def test_provider_branch_equals_salve_tpus(materialized, src, tmp_path, existing_panos):
    """From the ray cast, or from panos already on disk (the port decodes
    them with its own JPEG reader, salve_tpu with imageio)."""
    out = materialized[0]
    for side in ("ref", "got"):
        if existing_panos:
            shutil.copytree(out / "raw", tmp_path / side / "raw")
    jsz.materialize_synthetic_building(str(src), BID, str(tmp_path / "ref" / "raw"),
                                       depth_save_root=str(tmp_path / "ref" / "depth"), depth_provider=_provider)
    tsz.materialize_synthetic_building(str(src), BID, str(tmp_path / "got" / "raw"),
                                       depth_save_root=str(tmp_path / "got" / "depth"), depth_provider=_provider)
    _assert_trees_equal(tmp_path / "ref", tmp_path / "got")
    one = sorted((tmp_path / "got" / "depth" / BID).glob("*.png"))[0]
    gt = png.read_png(out / "depth" / BID / one.name)
    assert not np.array_equal(png.read_png(one), gt)  # the provider's depth, not the ray cast's


def test_load_depth_provider_fills_a_missing_map(materialized, src, tmp_path):
    """`load_depth_provider` on a small salve_tpu msgpack (ResNet-18, embed
    64, one block, float32, built for 512x1024) fills the one missing depth
    map from its existing pano, with the provider's own output."""
    import flax
    import jax
    import jax.numpy as jnp

    from salve_tpu.models import depth_net as jdn
    from salve_tpu_torch.models.depth_net import load_depth_provider

    jmodel = jdn.PanoDepthNet(num_layers=18, embed_dim=64, num_blocks=1, compute_dtype=jnp.float32)
    variables = jax.jit(lambda k: jmodel.init(k, jnp.zeros((1, 512, 1024, 3))))(jax.random.PRNGKey(0))
    fpath = tmp_path / "depth.msgpack"
    fpath.write_bytes(flax.serialization.to_bytes(
        {"params": variables["params"], "batch_stats": variables["batch_stats"]}))
    provider = load_depth_provider(str(fpath), num_layers=18, device="cpu")

    out = materialized[0]
    shutil.copytree(out / "raw", tmp_path / "raw")
    shutil.copytree(out / "depth", tmp_path / "depth")
    missing = sorted((tmp_path / "depth" / BID).glob("*.png"))[2]
    missing.unlink()
    tsz.materialize_synthetic_building(str(src), BID, str(tmp_path / "raw"), depth_save_root=str(tmp_path / "depth"),
                                       depth_provider=provider)
    pano = tmp_path / "raw" / BID / "panos" / missing.name.replace(".depth.png", ".jpg")
    want = np.clip(np.round(provider(jpeg.decode_jpeg(pano).astype(np.float32) / 255.0) * 1000.0), 0, 65535)
    np.testing.assert_array_equal(png.read_png(missing), want.astype(np.uint16))
    for p in sorted((tmp_path / "depth" / BID).glob("*.png")):
        if p != missing:
            assert _sha(p) == _sha(out / "depth" / BID / p.name)
