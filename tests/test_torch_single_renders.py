"""Single-image and single-pair renders of the port against salve_tpu's (CPU).

The same seeded numpy inputs go through salve_tpu (CPU JAX, as its own tests
run it) and the port with `device="cpu"`, where B1 and B2 run their plain
versions. Tolerances:
  * `render_bev_image` (both surfaces), `render_bev_pair`,
    `render_bev_pairs_batch`, `rasterize_room_layout_pair` and
    `rasterize_layout_batch_device`: none, the u8 images are equal. Inputs:
    panos ray-cast by `rendering/synthetic.py` at 32x64 and 64x128 with
    small grids, and one case at 512x1024 onto the default 501^2 grid;
  * `make_bevimg_Sim2_world`: equal arrays;
  * the pano-projection inverse chain (`cartesian_to_sphere` ...
    `xy_to_uv`): within 1e-12 of salve_tpu's float64 numpy path, and
    `worldmetric_to_pixel` undoes the port's `pixel_to_worldmetric` on
    below-horizon pixels within 1e-9 px.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salve_tpu.common.pano_data import PanoData as JPano
from salve_tpu.common.wdo import WDO as JWDO
from salve_tpu.geometry import pano_projection as jproj
from salve_tpu.geometry.sim2 import Sim2 as JSim2
from salve_tpu.ops import backproject as jbp
from salve_tpu.ops import bev as jbev
from salve_tpu.rendering import bev_pair as jbev_pair
from salve_tpu.rendering import layout as jlayout
from salve_tpu_torch import device as device_mod
from salve_tpu_torch.common.pano_data import PanoData
from salve_tpu_torch.common.wdo import WDO
from salve_tpu_torch.geometry import pano_projection as proj
from salve_tpu_torch.geometry.sim2 import Sim2
from salve_tpu_torch.ops import backproject as tbp
from salve_tpu_torch.ops import bev as tbev
from salve_tpu_torch.rendering import bev_pair as tbev_pair
from salve_tpu_torch.rendering import layout
from salve_tpu_torch.rendering.synthetic import render_synthetic_pano

ROOMS = [
    np.array([[-2.0, -1.5], [3.0, -1.5], [3.0, 2.5], [-2.0, 2.5]]),
    np.array([[-3.0, -2.0], [1.5, -2.5], [2.5, 0.5], [0.5, 3.0], [-2.5, 1.5]]),
    np.array([[-1.5, -3.0], [2.0, -3.0], [2.0, 1.0], [4.0, 1.0], [4.0, 3.0], [-1.5, 3.0]]),
]
# (pano h, w, grid img_px, meters_per_px): two narrow panos on small grids,
# and the production render (512x1024 -> 501^2 at 0.02 m/px).
SHAPES = [(32, 64, 60, 0.1), (64, 128, 100, 0.05), (512, 1024, 500, 0.02)]
SURFACES = [("floor", tbp.FLOOR_Z_RANGE), ("ceiling", tbp.CEILING_Z_RANGE)]


def _panos(h: int, w: int, n: int = 3):
    """(n, h, w) uint16 depth (mm) and (n, h, w, 3) float64 rgb in [0, 1]."""
    casts = [render_synthetic_pano(ROOMS[k % len(ROOMS)], 1.4 + 0.1 * k, h=h, w=w, seed=k) for k in range(n)]
    depths = np.stack([np.round(c["depth"] * 1000).astype(np.uint16) for c in casts])
    rgbs = np.stack([c["rgb"] / 255.0 for c in casts])
    return depths, rgbs


@pytest.mark.parametrize("h,w,px,mpp", SHAPES, ids=[f"{h}x{w}" for h, w, _, _ in SHAPES])
@pytest.mark.parametrize("surface,z_range", SURFACES, ids=[s for s, _ in SURFACES])
def test_render_bev_image_equals_salve_tpu(h, w, px, mpp, surface, z_range):
    depths, rgbs = _panos(h, w, 1)
    x, c, v = jbp.backproject_depth(jnp.asarray(depths[0]), jnp.asarray(rgbs[0]), z_range)
    want = np.asarray(jbev.render_bev_image(x, c, v, px, mpp))
    x, c, v = tbp.backproject_depth(torch.as_tensor(depths), torch.as_tensor(rgbs, dtype=torch.float32), z_range)
    got = tbev.render_bev_image(x[0], c[0], v[0], px, mpp).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape == (px + 1, px + 1, 3)
    np.testing.assert_array_equal(got, want)
    assert (want > 0).mean() > 0.05


def test_make_bevimg_sim2_world_equals_salve_tpu():
    for px, mpp in [(500, 0.02), (100, 0.05), (61, 0.1), (1000, 0.02)]:
        got, want = tbev.make_bevimg_Sim2_world(px, mpp), jbev.make_bevimg_Sim2_world(px, mpp)
        for a, b in zip(got[:2], want[:2]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert got[2] == want[2]
    assert tbev.make_bevimg_Sim2_world()[2] == jbev.make_bevimg_Sim2_world()[2] == 50.0


HYPOTHESES = [(25.0, (0.5, -0.25)), (-100.0, (-1.0, 0.75)), (180.0, (0.0, 1.2)), (7.5, (2.0, -0.4))]


@pytest.mark.parametrize("h,w,px,mpp", [SHAPES[1], SHAPES[2]], ids=["64x128", "512x1024"])
def test_render_bev_pair_equals_salve_tpu(h, w, px, mpp):
    depths, rgbs = _panos(h, w, 2)
    theta, t = HYPOTHESES[0]
    surfaces = ["floor", "ceiling"] if h < 512 else ["floor"]
    for surface in surfaces:
        jcfg = jbev_pair.BEVRenderConfig(img_px=px, meters_per_px=mpp)
        want = jbev_pair.render_bev_pair(depths[0], rgbs[0], depths[1], rgbs[1],
                                         JSim2.from_theta_deg(theta, np.array(t)), surface, jcfg)
        cfg = tbev_pair.BEVRenderConfig(img_px=px, meters_per_px=mpp)
        got = tbev_pair.render_bev_pair(depths[0], rgbs[0], depths[1], rgbs[1],
                                        Sim2.from_theta_deg(theta, np.array(t)), surface, cfg, device="cpu")
        for g, r in zip(got, want):
            assert g.dtype == np.uint8 and g.shape == (px + 1, px + 1, 3)
            np.testing.assert_array_equal(g, r)
        assert (want[0] > 0).mean() > 0.02 and (want[1] > 0).mean() > 0.02


@pytest.mark.parametrize("surface", ["floor", "ceiling"])
def test_render_bev_pairs_batch_equals_salve_tpu_and_its_rows(surface):
    """A bank of 3 panos and 4 pairs: the batch equals salve_tpu's, and each
    row equals the single-pair render of its pair."""
    h, w, px, mpp = SHAPES[1]
    depths, rgbs = _panos(h, w, 3)
    pairs = np.array([[0, 1], [2, 0], [1, 2], [0, 2]])
    sims = [Sim2.from_theta_deg(th, np.array(t)) for th, t in HYPOTHESES]
    R = np.stack([s.rotation for s in sims])
    t = np.stack([s.translation for s in sims])
    jcfg = jbev_pair.BEVRenderConfig(img_px=px, meters_per_px=mpp)
    cfg = tbev_pair.BEVRenderConfig(img_px=px, meters_per_px=mpp)
    want = jbev_pair.render_bev_pairs_batch(depths, rgbs, pairs, R, t, surface, jcfg)
    got = tbev_pair.render_bev_pairs_batch(depths, rgbs, pairs, R, t, surface, cfg, device="cpu")
    for g, r in zip(got, want):
        assert g.dtype == np.uint8 and g.shape == (len(pairs), px + 1, px + 1, 3)
        np.testing.assert_array_equal(g, r)
    k = 1
    single = tbev_pair.render_bev_pair(depths[pairs[k, 0]], rgbs[pairs[k, 0]], depths[pairs[k, 1]],
                                       rgbs[pairs[k, 1]], sims[k], surface, cfg, device="cpu")
    np.testing.assert_array_equal(single[0], got[0][k])
    np.testing.assert_array_equal(single[1], got[1][k])


def _pano(cls, wdo_cls, sim_cls, pid, room, pose, wdos):
    w = lambda a, b, kind: wdo_cls(sim_cls.from_theta_deg(*pose), a, b, 0.0, 2.0, kind)
    return cls(id=pid, global_Sim2_local=sim_cls.from_theta_deg(*pose), room_vertices_local_2d=room,
               image_path=f"floor_01_partial_room_01_pano_{pid}.jpg", label="room",
               doors=[w(*x) for x in wdos if x[2] == "doors"], windows=[w(*x) for x in wdos if x[2] == "windows"],
               openings=[w(*x) for x in wdos if x[2] == "openings"])


def _pair_panos(cls, wdo_cls, sim_cls):
    wdos1 = [((1.0, 0.5), (1.0, -0.5), "doors"), ((-1.0, 1.0), (0.0, 1.2), "windows")]
    wdos2 = [((-2.0, 0.0), (-2.0, 0.8), "openings"), ((0.5, -2.5), (1.5, -2.5), "windows"),
             ((2.5, 0.2), (2.5, -0.6), "doors")]
    return (_pano(cls, wdo_cls, sim_cls, 1, ROOMS[1] * 0.4, (20.0, np.array([0.3, 0.1])), wdos1),
            _pano(cls, wdo_cls, sim_cls, 2, ROOMS[2] * 0.4, (-35.0, np.array([-0.2, 0.4])), wdos2))


@pytest.mark.parametrize("theta,t", HYPOTHESES[:2])
def test_rasterize_room_layout_pair_equals_salve_tpu(theta, t):
    p1, p2 = _pair_panos(PanoData, WDO, Sim2)
    j1, j2 = _pair_panos(JPano, JWDO, JSim2)
    got = layout.rasterize_room_layout_pair(Sim2.from_theta_deg(theta, np.array(t)), p1, p2, device="cpu")
    want = jlayout.rasterize_room_layout_pair(JSim2.from_theta_deg(theta, np.array(t)), j1, j2)
    for g, r in zip(got, want):
        assert g.dtype == np.uint8 and g.shape == (501, 501, 3)
        np.testing.assert_array_equal(g, r)
        assert (r == 255).any() and (r[..., 0] != r[..., 1]).any()  # room fill and coloured lines


def test_rasterize_layout_batch_device_equals_salve_tpu():
    """salve_tpu's jitted batch entry on the same padded arrays (two layouts,
    a small grid); the port's counts may stay on the host."""
    p1, p2 = _pair_panos(PanoData, WDO, Sim2)
    padded = [layout._pad_layout(p.room_vertices_local_2d, p.all_wdos, layout.MAX_ROOM_VERTS, layout.MAX_WDOS)
              for p in (p1, p2)]
    got = layout.rasterize_layout_batch_device(*layout._stack_padded(padded, torch.device("cpu")), 200, 0.025)
    want = jlayout.rasterize_layout_batch_device(
        jnp.asarray(np.stack([p[0] for p in padded])), jnp.asarray(np.array([p[1] for p in padded], np.int32)),
        jnp.asarray(np.stack([p[2] for p in padded])), jnp.asarray(np.stack([p[3] for p in padded])),
        jnp.asarray(np.array([p[4] for p in padded], np.int32)), 200, 0.025)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (2, 201, 201, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pano_projection_inverse_chain_equals_salve_tpu():
    rng = np.random.default_rng(11)
    width, cam_h = 1024, 1.35
    px = np.stack([rng.uniform(0, width - 1, 500), rng.uniform(width / 4 + 2, width / 2 - 2, 500)], -1)
    world = proj.pixel_to_worldmetric(px, width, cam_h)
    np.testing.assert_array_equal(world, jproj.pixel_to_worldmetric(px, width, cam_h))
    cart = rng.normal(size=(500, 3))
    xy = world[:, :2]
    pairs = [
        (proj.cartesian_to_sphere(cart), jproj.cartesian_to_sphere(cart)),
        (proj.sphere_to_pixel(proj.cartesian_to_sphere(cart), width),
         jproj.sphere_to_pixel(jproj.cartesian_to_sphere(cart), width)),
        (proj.worldmetric_to_room_cartesian(world, cam_h), jproj.worldmetric_to_room_cartesian(world, cam_h)),
        (proj.worldmetric_to_pixel(world, width, cam_h), jproj.worldmetric_to_pixel(world, width, cam_h)),
        (proj.xy_to_u(xy), jproj.xy_to_u(xy)),
        (proj.xy_to_uv(xy, cam_h, width, width // 2), jproj.xy_to_uv(xy, cam_h, width, width // 2)),
    ]
    for got, want in pairs:
        assert got.dtype == want.dtype == np.float64 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # The round trip: below the horizon, world-metric -> pixel undoes pixel -> world-metric.
    np.testing.assert_allclose(proj.worldmetric_to_pixel(world, width, cam_h), px, rtol=0, atol=1e-9)
    u = proj.xy_to_u(xy)
    assert ((u >= 0) & (u <= 1)).all()


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_single_renders_take_the_card_by_default(no_cuda, tmp_path):
    """The host-array renders and the depth-map CLI's image function take
    `device=None` as the card and raise without one, before reading a file."""
    from salve_tpu_torch.cli.visualize_backprojected_depthmap import backprojected_bev_images

    depths, rgbs = _panos(32, 64, 2)
    p1, p2 = _pair_panos(PanoData, WDO, Sim2)
    S = Sim2.from_theta_deg(10.0, np.zeros(2))
    calls = [
        lambda: tbev_pair.render_bev_pair(depths[0], rgbs[0], depths[1], rgbs[1], S, "floor"),
        lambda: tbev_pair.render_bev_pairs_batch(depths, rgbs, np.array([[0, 1]]), S.rotation[None],
                                                 S.translation[None], "floor"),
        lambda: layout.rasterize_room_layout_pair(S, p1, p2),
        lambda: backprojected_bev_images(str(tmp_path / "absent.png"), str(tmp_path / "absent.jpg")),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    device_mod.reset_launch_counts()
    tbev_pair.render_bev_pair(depths[0], rgbs[0], depths[1], rgbs[1], S, "floor",
                              tbev_pair.BEVRenderConfig(img_px=60, meters_per_px=0.1), device="cpu")
    assert device_mod.launch_counts() == {"splat": 0, "fill": 0, "warp": 0}
