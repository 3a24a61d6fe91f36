"""Semantic renders, the z-order and interpolation helpers and the ICP
baseline against salve_tpu's, on the CPU.

Tolerances, each stated at its test:
  * `nearest_fill`, `fill_holes`, `hallucination_mask`, the semantic BEV
    render (`is_semantics=True`, through `render_bev_images_batched` and
    `render_identity_batched`), `choose_elevated_repeated_vals`,
    `interp_dense_grid_from_sparse` (both `is_semantics` values) and
    `remove_hallucinated_content`: exactly salve_tpu's, on seeded sparse
    grids and clouds of the kinds tests/utils/test_reference_shims.py uses;
  * ICP (point-to-point and colored multi-scale) on
    tests/baselines/test_baselines.py's seeded box clouds: the transform
    within 1e-4 of salve_tpu's (rotation Frobenius, translation in m), and
    the known motion recovered within that test's bounds; voxel
    downsampling exactly salve_tpu's;
  * `cli/register_depth_maps_icp.py` on two materialized panos of one room:
    the backprojected clouds equal salve_tpu's, the transform within 1e-4.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salve_tpu.baselines import icp as jicp
from salve_tpu.geometry.rotations3d import rot3_rzryrx
from salve_tpu.ops import backproject as jbp
from salve_tpu.ops import bev as jbev
from salve_tpu.rendering import bev_pair as jbev_pair
from salve_tpu.utils import interpolation_utils as jinterp
from salve_tpu.utils import zorder_utils as jzorder
from salve_tpu_torch.baselines import icp
from salve_tpu_torch.ops import backproject as tbp
from salve_tpu_torch.ops import bev as tbev
from salve_tpu_torch.rendering import bev_pair as tbev_pair
from salve_tpu_torch.utils import interpolation_utils as tinterp
from salve_tpu_torch.utils import zorder_utils as tzorder

CPU = "cpu"


def _sparse(seed: int, b: int = 2, h: int = 37, w: int = 53, density: float = 0.05, palette: bool = False):
    """(B, H, W, 3) float32 sparse colours and (B, H, W) occupancy; with
    `palette`, a few exact label colours (some with a zero channel)."""
    rng = np.random.default_rng(seed)
    occ = rng.uniform(size=(b, h, w)) < density
    if palette:
        colours = np.array([[0, 0, 0], [255, 0, 0], [12, 200, 40], [90, 90, 250], [7, 255, 131]], np.float32)
        sp = colours[rng.integers(0, len(colours), (b, h, w))]
    else:
        sp = rng.integers(0, 256, (b, h, w, 3)).astype(np.float32)
    return np.where(occ[..., None], sp, 0.0).astype(np.float32), occ


@pytest.mark.parametrize("seed,density,palette", [(0, 0.02, True), (1, 0.1, False), (2, 0.5, True), (3, 0.0, False)])
def test_fills_and_mask_equal_salve_tpus(seed, density, palette):
    sp, occ = _sparse(seed, density=density, palette=palette)
    sp_u8 = np.clip(np.round(sp), 0, 255).astype(np.uint8)
    for name, ref, got in (
        ("nearest_fill", jbev.nearest_fill(jnp.asarray(sp), jnp.asarray(occ)),
         tbev.nearest_fill(torch.from_numpy(sp), torch.from_numpy(occ))),
        ("fill_holes", jbev.fill_holes(jnp.asarray(sp), jnp.asarray(occ)),
         tbev.fill_holes(torch.from_numpy(sp), torch.from_numpy(occ))),
        ("hallucination_mask", jbev.hallucination_mask(jnp.asarray(sp_u8)),
         tbev.hallucination_mask(torch.from_numpy(sp_u8))),
        ("hallucination_mask k=5", jbev.hallucination_mask(jnp.asarray(sp_u8), k=5),
         tbev.hallucination_mask(torch.from_numpy(sp_u8), k=5)),
    ):
        ref = np.asarray(ref)
        assert got.shape == ref.shape and got.numpy().dtype == ref.dtype, name
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=name)
    # One image without the batch axis, as salve_tpu's helpers accept it.
    np.testing.assert_array_equal(tbev.nearest_fill(torch.from_numpy(sp[0]), torch.from_numpy(occ[0])).numpy(),
                                  np.asarray(jbev.nearest_fill(jnp.asarray(sp[0]), jnp.asarray(occ[0]))))


def _clouds(seed: int, b: int = 3, h: int = 64, w: int = 128, z_range=jbp.FLOOR_Z_RANGE, labels: bool = True):
    """Backprojected (B, N) clouds of seeded depth maps, coloured by a few
    label colours (a semantic map) or by noise, as numpy."""
    rng = np.random.default_rng(seed)
    depths = rng.uniform(1000, 4000, (b, h, w)).astype(np.uint16)
    if labels:
        palette = np.array([[255, 0, 0], [0, 255, 0], [10, 20, 250], [200, 200, 200]]) / 255.0
        rgbs = palette[rng.integers(0, 4, (b, h, w))].astype(np.float32)
    else:
        rgbs = (rng.integers(0, 256, (b, h, w, 3)) / 255.0).astype(np.float32)
    window = tbp.surface_row_window(h, z_range, 0.1)
    xyz, c, v = tbp.backproject_depth(torch.from_numpy(depths), torch.from_numpy(rgbs), z_range, 0.1, window)
    return depths, rgbs, xyz.numpy(), c.numpy(), v.numpy()


@pytest.mark.parametrize("seed,labels", [(0, True), (1, False)])
def test_semantic_render_equals_salve_tpus(seed, labels):
    _, _, xyz, c, v = _clouds(seed, labels=labels)
    ref = np.asarray(jbev.render_bev_images_batched(jnp.asarray(xyz), jnp.asarray(c), jnp.asarray(v), img_px=100,
                                                    meters_per_px=0.1, is_semantics=True))
    got = tbev.render_bev_images_batched(torch.from_numpy(xyz), torch.from_numpy(c), torch.from_numpy(v), img_px=100,
                                         meters_per_px=0.1, is_semantics=True).numpy()
    assert got.dtype == np.uint8 and got.shape == ref.shape == (3, 101, 101, 3)
    np.testing.assert_array_equal(got, ref)
    assert (ref > 0).mean() > 0.05
    # Unlike the texture branch, no hull: the semantic render reaches
    # cells the texture render leaves black.
    tex = tbev.render_bev_images_batched(torch.from_numpy(xyz), torch.from_numpy(c), torch.from_numpy(v), img_px=100,
                                         meters_per_px=0.1).numpy()
    assert not np.array_equal(got, tex)


@pytest.mark.parametrize("z_range", [jbp.FLOOR_Z_RANGE, jbp.CEILING_Z_RANGE])
def test_semantic_identity_render_equals_salve_tpus(z_range):
    depths, rgbs, *_ = _clouds(2, b=2, h=128, w=256, z_range=z_range)
    surface = "floor" if z_range == jbp.FLOOR_Z_RANGE else "ceiling"
    jcfg = jbev_pair.BEVRenderConfig(img_px=200, meters_per_px=0.05, is_semantics=True)
    tcfg = tbev_pair.BEVRenderConfig(img_px=200, meters_per_px=0.05, is_semantics=True)
    ref = np.asarray(jbev_pair.render_identity_batched(jnp.asarray(depths), jnp.asarray(rgbs),
                                                       jbev_pair._z_range_for_surface(surface), jcfg))
    got = tbev_pair.render_identity_batched(torch.from_numpy(depths), torch.from_numpy(rgbs),
                                            tbev_pair._z_range_for_surface(surface), tcfg).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (ref > 0).any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_choose_elevated_repeated_vals_equals_salve_tpus(seed):
    rng = np.random.default_rng(seed)
    n = 400
    x, y = rng.integers(0, 12, n), rng.integers(0, 10, n)
    z = rng.uniform(-3, 3, n)
    z[:20] = np.array([-2.0, -1.0, 0.0, 1.0, 2.0] * 4)  # bin edges and the range's ends
    ref = jzorder.choose_elevated_repeated_vals(x, y, z)
    got = tzorder.choose_elevated_repeated_vals(x, y, z, device=CPU)
    assert got.dtype == ref.dtype == bool
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < n
    with pytest.raises(NotImplementedError):
        tzorder.choose_elevated_repeated_vals(x, y, z, num_slices=8, device=CPU)


@pytest.mark.parametrize("is_semantics", [False, True])
def test_interp_dense_grid_from_sparse_equals_salve_tpus(is_semantics):
    rng = np.random.default_rng(4)
    img = np.zeros((48, 40, 3), np.uint8)
    pts = rng.uniform(-2, 45, (150, 2))  # some outside the grid, dropped
    vals = rng.integers(1, 256, (150, 3)).astype(np.float64)
    ref = jinterp.interp_dense_grid_from_sparse(img, pts, vals, 48, 40, is_semantics)
    got = tinterp.interp_dense_grid_from_sparse(img, pts, vals, 48, 40, is_semantics, device=CPU)
    assert got.dtype == ref.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)
    assert (got > 0).mean() > 0.5
    # Degenerate inputs return the input grid itself, as salve_tpu's do.
    assert tinterp.interp_dense_grid_from_sparse(img, pts[:3], vals[:3], 48, 40, is_semantics, device=CPU) is img
    col = np.array([[1.0, 0], [1.0, 2], [1.0, 4], [1.0, 6]])
    assert tinterp.interp_dense_grid_from_sparse(img, col, vals[:4], 48, 40, is_semantics, device=CPU) is img
    assert tinterp.is_collinear(col) == jinterp.is_collinear(col)


@pytest.mark.parametrize("k", [11, 5])
def test_remove_hallucinated_content_equals_salve_tpus(k):
    rng = np.random.default_rng(5)
    sparse = np.zeros((32, 32, 3), np.uint8)
    idx = rng.integers(0, 32, (6, 2))
    sparse[idx[:, 0], idx[:, 1]] = rng.integers(0, 40, (6, 3))  # some with a zero channel: no support
    sparse[16, 16] = [10, 10, 10]
    interp = rng.integers(0, 256, (32, 32, 3)).astype(np.uint8)
    ref = jinterp.remove_hallucinated_content(sparse, interp, K=k)
    got = tinterp.remove_hallucinated_content(sparse, interp, K=k, device=CPU)
    np.testing.assert_array_equal(got, ref)
    assert (got == 0).any() and (got == interp).all(axis=-1).any()


# ------------------------------------------------------------------ ICP


def _box_cloud(n=3000, seed=0):
    """tests/baselines/test_baselines.py's box-like indoor structure: three
    walls and a floor."""
    rng = np.random.default_rng(seed)
    pts = [
        np.c_[rng.uniform(0, 4, n // 4), np.zeros(n // 4), rng.uniform(0, 2, n // 4)],
        np.c_[np.zeros(n // 4), rng.uniform(0, 3, n // 4), rng.uniform(0, 2, n // 4)],
        np.c_[rng.uniform(0, 4, n // 4), rng.uniform(0, 3, n // 4), np.zeros(n // 4)],
        np.c_[np.full(n // 4, 4.0), rng.uniform(0, 3, n // 4), rng.uniform(0, 2, n // 4)],
    ]
    return np.vstack(pts)


def _assert_close_transforms(got, ref, tol=1e-4):
    assert np.linalg.norm(got[:3, :3] - ref[:3, :3]) <= tol, np.linalg.norm(got[:3, :3] - ref[:3, :3])
    assert np.abs(got[:3, 3] - ref[:3, 3]).max() <= tol, np.abs(got[:3, 3] - ref[:3, 3]).max()
    assert np.isclose(np.linalg.det(got[:3, :3]), 1.0, atol=1e-5)


def test_voxel_downsample_equals_salve_tpus():
    pts = _box_cloud(seed=3)
    cols = np.random.default_rng(4).uniform(0, 1, (len(pts), 3))
    for voxel in (0.04, 0.2):
        ref, ref_c = jicp.voxel_downsample(pts, voxel, cols)
        got, got_c = icp.voxel_downsample(pts, voxel, cols)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got_c, ref_c)
    assert icp.voxel_downsample(np.array([[0.0, 0, 0], [0.01, 0, 0], [1.0, 1, 1]]), 0.1).shape == (2, 3)
    ref = jicp._subsample(pts, cols, 1000)
    got = icp._subsample(pts, cols, 1000)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])


def test_point_to_point_icp_equals_salve_tpus():
    src = _box_cloud()
    R_true = rot3_rzryrx(0.0, 0.0, np.deg2rad(3.0))
    t_true = np.array([0.05, -0.03, 0.02])
    tgt = src @ R_true.T + t_true
    ref = jicp.register_point_clouds(src, tgt, max_correspondence_distance=0.3)
    got = icp.register_point_clouds(src, tgt, max_correspondence_distance=0.3, device=CPU)
    _assert_close_transforms(got, ref)
    assert np.allclose(got[:3, :3], R_true, atol=0.01)
    assert np.allclose(got[:3, 3], t_true, atol=0.02)


def test_colored_icp_equals_salve_tpus():
    src = _box_cloud()
    colors = np.random.default_rng(1).uniform(0, 1, (src.shape[0], 3))
    R_true = rot3_rzryrx(0.0, 0.0, np.deg2rad(2.0))
    t_true = np.array([0.03, 0.02, -0.01])
    tgt = src @ R_true.T + t_true
    ref = jicp.register_colored_point_clouds(np.hstack([src, colors]), np.hstack([tgt, colors]))
    got = icp.register_colored_point_clouds(np.hstack([src, colors]), np.hstack([tgt, colors]), device=CPU)
    _assert_close_transforms(got, ref)
    assert np.allclose(got[:3, :3], R_true, atol=0.02)
    assert np.allclose(got[:3, 3], t_true, atol=0.03)


def test_umeyama_gives_a_proper_rotation_under_a_reflection():
    """The determinant correction: a mirrored target still fits a rotation."""
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.normal(size=(50, 3)).astype(np.float32))
    b = a * torch.tensor([1.0, 1.0, -1.0])
    R, _ = icp._umeyama(a, b, torch.ones(50))
    assert abs(float(torch.linalg.det(R)) - 1.0) < 1e-5


def test_register_depth_maps_cli_equals_salve_tpus(tmp_path):
    """Two panos of one room, materialized with their depth maps."""
    from salve_tpu.cli import register_depth_maps_icp as jcli
    from salve_tpu_torch.cli import register_depth_maps_icp as tcli
    from salve_tpu_torch.dataset.procedural import generate_building_json
    from salve_tpu_torch.dataset.synthetic_zind import materialize_synthetic_building

    (tmp_path / "src" / "0000").mkdir(parents=True)
    building = generate_building_json(1, n_rows=1, n_cols=2)
    (tmp_path / "src" / "0000" / "zind_data.json").write_text(json.dumps(building))
    materialize_synthetic_building(str(tmp_path / "src"), "0000", str(tmp_path / "raw"),
                                   depth_save_root=str(tmp_path / "depth"))
    panos = sorted((tmp_path / "raw" / "0000" / "panos").glob("*.jpg"))
    rooms = {}
    for p in panos:
        rooms.setdefault(p.stem.split("_pano_")[0], []).append(p)
    p1, p2 = next(v for v in rooms.values() if len(v) >= 2)[:2]
    d1, d2 = (tmp_path / "depth" / "0000" / f"{p.stem}.depth.png" for p in (p1, p2))

    for d, p in ((d1, p1), (d2, p2)):
        np.testing.assert_array_equal(tcli.backproject_pano(str(d), str(p), device=CPU),
                                      jcli.backproject_pano(str(d), str(p)))
    ref = jicp.register_colored_point_clouds(jcli.backproject_pano(str(d1), str(p1)),
                                             jcli.backproject_pano(str(d2), str(p2)))
    got = tcli.main(["--depth_fpath_1", str(d1), "--rgb_fpath_1", str(p1), "--depth_fpath_2", str(d2),
                     "--rgb_fpath_2", str(p2), "--save_fpath", str(tmp_path / "T.npy"), "--device", CPU])
    _assert_close_transforms(got, ref)
    np.testing.assert_array_equal(np.load(tmp_path / "T.npy"), got)
