"""The port's point-set fits and batched Sim(2) ops against salve_tpu (CPU).

`fit_se2`, `fit_sim3` and `align_points_sim3` run in float32 on both sides
(JAX with 64-bit mode off), with sums in different orders: R, t and s within
atol 1e-5. The sim2_batch ops are a few float32 operations each: within
1e-6. The numpy host wrappers are copies: equal exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salve_tpu.common.pano_data import FloorData as JaxFloorData
from salve_tpu.geometry import point_alignment as jpa
from salve_tpu.geometry import sim2_batch as jsb
from salve_tpu.geometry.sim2 import Sim2 as JaxSim2
from salve_tpu_torch.dataset import procedural
from salve_tpu_torch.geometry import point_alignment as pa
from salve_tpu_torch.geometry import sim2_batch as sb
from salve_tpu_torch.geometry.sim2 import Sim2


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float32))


def _close(got, ref, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=atol)


def _random_se2_pairs(rng, shape, n):
    th = rng.uniform(-np.pi, np.pi, shape)
    R = np.stack([np.stack([np.cos(th), -np.sin(th)], -1), np.stack([np.sin(th), np.cos(th)], -1)], -2)
    pts_b = rng.uniform(-3, 3, shape + (n, 2))
    t = rng.uniform(-2, 2, shape + (2,))
    pts_a = np.einsum("...ij,...nj->...ni", R, pts_b) + t[..., None, :] + rng.normal(0, 0.01, shape + (n, 2))
    return pts_a.astype(np.float32), pts_b.astype(np.float32)


@pytest.mark.parametrize("weighted", [False, True])
def test_fit_se2_matches_jax(weighted):
    rng = np.random.default_rng(0)
    pts_a, pts_b = _random_se2_pairs(rng, (6, 4), 5)
    w = (rng.uniform(size=(6, 4, 5)) < 0.7).astype(np.float32) + 0.5 if weighted else None
    R, t = pa.fit_se2(_t(pts_a), _t(pts_b), None if w is None else _t(w))
    Rj, tj = jpa.fit_se2(jnp.asarray(pts_a), jnp.asarray(pts_b), None if w is None else jnp.asarray(w))
    _close(R, Rj, 1e-5)
    _close(t, tj, 1e-5)


def _random_sim3_pairs(rng, shape, n):
    A = rng.normal(size=shape + (3, 3))
    Q, _ = np.linalg.qr(A)
    Q = Q * np.sign(np.linalg.det(Q))[..., None, None]  # proper rotations
    pts_b = rng.uniform(-2, 2, shape + (n, 3))
    t = rng.uniform(-1, 1, shape + (3,))
    s = rng.uniform(0.5, 2.0, shape)
    pts_a = s[..., None, None] * (np.einsum("...ij,...nj->...ni", Q, pts_b) + t[..., None, :])
    pts_a = pts_a + rng.normal(0, 0.005, pts_a.shape)
    return pts_a.astype(np.float32), pts_b.astype(np.float32)


@pytest.mark.parametrize("weighted", [False, True])
def test_fit_sim3_matches_jax(weighted):
    rng = np.random.default_rng(1)
    pts_a, pts_b = _random_sim3_pairs(rng, (8,), 7)
    w = rng.uniform(0.5, 1.5, (8, 7)).astype(np.float32) if weighted else None
    R, t, s = pa.fit_sim3(_t(pts_a), _t(pts_b), None if w is None else _t(w))
    Rj, tj, sj = jpa.fit_sim3(jnp.asarray(pts_a), jnp.asarray(pts_b), None if w is None else jnp.asarray(w))
    _close(R, Rj, 1e-5)
    _close(t, tj, 1e-5)
    _close(s, sj, 1e-5)


def _wdo_outline_pairs(seed):
    """(pano2 outline, pano1 outline) of every same-type door pairing of a
    procedural floor, as the Sim(3) path of wdo_alignment fits them."""
    b = procedural.generate_building_json(seed=seed)
    fd = JaxFloorData.from_json(b["merger"]["floor_01"], "floor_01")
    doors = [d for p in fd.panos for d in p.doors]
    return [(d2.polygon_vertices_local_3d, d1.polygon_vertices_local_3d) for d1 in doors[:6] for d2 in doors[:6]]


@pytest.mark.parametrize("seed", [2, 11])
def test_align_points_sim3_fits_in_float32_as_jax_does(seed):
    rng = np.random.default_rng(seed)
    cases = _wdo_outline_pairs(seed) + [_random_sim3_pairs(rng, (), 6) for _ in range(4)]
    for a, b in cases:
        got, got_pts = pa.align_points_sim3(a, b)
        ref, ref_pts = jpa.align_points_sim3(a, b)
        np.testing.assert_allclose(got.rotation, ref.rotation, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.translation, ref.translation, rtol=0, atol=1e-5)
        assert abs(got.scale - ref.scale) <= 1e-5
        np.testing.assert_allclose(got_pts, ref_pts, rtol=0, atol=1e-4)
    assert pa.align_points_sim3(np.zeros((4, 2)), np.zeros((4, 3)))[0] is None


def test_host_se2_wrappers_are_copies():
    rng = np.random.default_rng(3)
    for _ in range(5):
        a, b = _random_se2_pairs(rng, (), 5)
        got, got_pts = pa.align_points_SE2(a, b)
        ref, ref_pts = jpa.align_points_SE2(a, b)
        assert got.rotation.tobytes() == ref.rotation.tobytes()
        assert got.translation.tobytes() == ref.translation.tobytes()
        assert np.array_equal(got_pts, ref_pts)
    assert pa.align_points_SE2(np.zeros((1, 2)), np.zeros((1, 2))) == (None, None)
    skewed = Sim2(np.array([[0.9, -0.5], [0.3, 1.1]]), np.array([0.2, -0.4]), 1.3)
    jskewed = JaxSim2(skewed.rotation, skewed.translation, skewed.scale)
    got, ref = pa.reorthonormalize_sim2(skewed), jpa.reorthonormalize_sim2(jskewed)
    assert got.rotation.tobytes() == ref.rotation.tobytes() and got.scale == ref.scale


def _random_sim2_batch(rng, shape):
    th = rng.uniform(-np.pi, np.pi, shape).astype(np.float32)
    t = rng.uniform(-3, 3, shape + (2,)).astype(np.float32)
    s = rng.uniform(0.5, 2.0, shape).astype(np.float32)
    return th, t, s


def test_sim2_batch_ops_match_jax():
    rng = np.random.default_rng(4)
    shape = (3, 5)
    a_np, b_np = _random_sim2_batch(rng, shape), _random_sim2_batch(rng, shape)
    a, b = sb.from_theta(*(_t(x) for x in a_np)), sb.from_theta(*(_t(x) for x in b_np))
    aj, bj = jsb.from_theta(*(jnp.asarray(x) for x in a_np)), jsb.from_theta(*(jnp.asarray(x) for x in b_np))
    for got, ref in zip(a, aj):
        _close(got, ref, 1e-6)
    for got, ref in zip(sb.compose(a, b), jsb.compose(aj, bj)):
        _close(got, ref, 1e-6)
    for got, ref in zip(sb.inverse(a), jsb.inverse(aj)):
        _close(got, ref, 1e-6)
    pts = rng.uniform(-2, 2, shape + (7, 2)).astype(np.float32)
    _close(sb.transform(a, _t(pts)), jsb.transform(aj, jnp.asarray(pts)), 1e-6)
    _close(sb.theta_deg(a), jsb.theta_deg(aj), 1e-6)
    for got, ref in zip(sb.identity((2, 3)), jsb.identity((2, 3))):
        assert got.shape == ref.shape
        _close(got, ref, 0)
    atol = (_t(0.35), _t(0.35), _t(7.0))
    assert np.array_equal(
        sb.almost_equal(a, b, *atol).numpy(),
        np.asarray(jsb.almost_equal(aj, bj, *(jnp.float32(x) for x in (0.35, 0.35, 7.0)))),
    )
    near = (a[0], a[1] + 0.1, a[2] + 0.1)
    assert bool(sb.almost_equal(a, near, *atol).all())


def test_wrap_angle_deg_is_a_floor_mod():
    """Negative differences and multiples of 360 wrap as the reference's `%`
    (floor-mod) wraps them, which a truncating fmod would not."""
    rng = np.random.default_rng(5)
    a1 = np.concatenate([rng.uniform(-1000, 1000, 200), [0, 180, -180, 360, -540, 179.5]]).astype(np.float32)
    a2 = np.concatenate([rng.uniform(-1000, 1000, 200), [-180, -180, 180, 0, 540, -180.5]]).astype(np.float32)
    got = sb.wrap_angle_deg(_t(a1), _t(a2))
    _close(got, jsb.wrap_angle_deg(jnp.asarray(a1), jnp.asarray(a2)), 1e-6)
    assert float(got.max()) <= 180.0
