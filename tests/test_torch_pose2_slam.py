"""The port's float64 pose-graph LM against salve_tpu's (CPU).

The Jacobian is held entry for entry against `jax.jacfwd` of the same
residual, NaN positions included: a Huber block whose whitened residual is
exactly zero has NaN rows in JAX (the norm's derivative is 0/0 and lax.max /
lax.min keep it through a 0 weight), and on every Stage D floor that block
is the prior, so salve_tpu's LM rejects all its steps. Finite entries agree
within 1e-12 (the two differ only in the rounding of a few products).
`planar_slam` is held within 1e-8 on the reference's GTSAM fixtures and on a
floor-sized graph with a nonzero prior (where the LM moves), and to the bit
on an identity-prior floor (where it does not).
"""

import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salve_tpu.algorithms import pose2_slam as jslam
from salve_tpu.geometry.pose2 import Pose2 as JaxPose2
from salve_tpu.geometry.sim2 import Sim2 as JaxSim2
from salve_tpu_torch.algorithms import pose2_slam as slam
from salve_tpu_torch.geometry.pose2 import Pose2
from salve_tpu_torch.geometry.sim2 import Sim2
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _jax_jacobian(state, n, n_lms, odo_idx, odo_meas, brm_idx, brm_meas, robust):
    """jax.jacfwd of salve_tpu's res_local at delta = 0 (pose2_slam.py:175-188)."""

    def res_local(delta, st):
        p, l = st[: n * 3].reshape(n, 3), st[n * 3 :].reshape(n_lms, 2)
        dp, dl = delta[: n * 3].reshape(n, 3), delta[n * 3 :].reshape(n_lms, 2)
        return jslam._residuals(
            jslam._compose(p, dp), l + dl, jnp.asarray(odo_idx), jnp.asarray(odo_meas), jnp.ones(len(odo_idx)), 0,
            jnp.asarray(brm_idx), jnp.asarray(brm_meas), jnp.ones(len(brm_idx)), robust,
        )

    with jax.enable_x64(True):
        return np.asarray(jax.jit(jax.jacfwd(res_local))(jnp.zeros(state.shape), jnp.asarray(state)))


def _graph(rng, n, n_lms, n_odo, n_brm):
    odo_idx = np.array([rng.choice(n, 2, replace=False) for _ in range(n_odo)])
    odo_meas = rng.normal(size=(n_odo, 3))
    brm_idx = np.stack([rng.integers(0, n, n_brm), rng.integers(0, max(n_lms, 1), n_brm)], 1)[: n_brm if n_lms else 0]
    brm_meas = np.stack([rng.uniform(-3, 3, n_brm), rng.uniform(0.5, 3, n_brm)], 1)[: len(brm_idx)]
    return odo_idx, odo_meas, brm_idx.reshape(-1, 2), brm_meas.reshape(-1, 2)


@pytest.mark.parametrize("robust", [True, False], ids=["huber", "plain"])
@pytest.mark.parametrize("n_lms", [0, 3], ids=["pgo", "landmarks"])
@pytest.mark.parametrize("prior", ["zero", "random"])
def test_jacobian_equals_jax_jacfwd(prior, n_lms, robust):
    rng = np.random.default_rng(7 + n_lms)
    n = 6
    poses = rng.normal(size=(n, 3))
    if prior == "zero":
        poses[0] = 0.0
    # A between factor whose residual is exactly zero, identity poses and an
    # identity measurement (exact whatever the order of rounding): its block
    # is NaN too.
    odo_idx, odo_meas, brm_idx, brm_meas = _graph(rng, n, n_lms, 9, 7)
    odo_idx[0] = [1, 2]
    odo_meas[0] = 0.0
    poses[1:3] = 0.0
    lms = rng.normal(size=(n_lms, 2)) * 3
    state = np.concatenate([poses.ravel(), lms.ravel()])

    want = _jax_jacobian(state, n, n_lms, odo_idx, odo_meas, brm_idx, brm_meas, robust)
    prob = slam._Problem(n, n_lms, *(torch.as_tensor(x) for x in (odo_idx, odo_meas, brm_idx, brm_meas)), robust)
    got = prob.jacobian(torch.as_tensor(state)).numpy()
    assert got.shape == want.shape == (3 + 3 * 9 + 2 * len(brm_idx), 3 * n + 2 * n_lms)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    nan_rows = np.isnan(want).any(axis=1)
    if robust:
        # The two zero-residual blocks, whole rows: the prior's when it is zero, and the between factor's.
        assert nan_rows[3:6].all() and nan_rows[:3].all() == (prior == "zero")
        assert np.isnan(want[nan_rows]).all() and nan_rows.sum() == 3 * (1 + (prior == "zero"))
    else:
        assert not nan_rows.any()
    finite = ~np.isnan(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=0, atol=1e-12)


def _to_jax(poses):
    return [None if p is None else JaxPose2(*p) for p in poses]


def _assert_poses_close(got, want, atol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_allclose(np.array(g), np.array(w), rtol=0, atol=atol)


def _both(init, odo, lms_init, brms, poses_only, robust=True):
    got = slam.planar_slam(init, [slam.OdometryMeasurement(m[0], m[1], Pose2(*m[2])) for m in odo], lms_init,
                           [slam.BearingRangeMeasurement(*b) for b in brms], poses_only, robust, device="cpu")
    want = jslam.planar_slam(_to_jax(init), [jslam.OdometryMeasurement(m[0], m[1], JaxPose2(*m[2])) for m in odo],
                             lms_init, [jslam.BearingRangeMeasurement(*b) for b in brms], poses_only, robust)
    return got, want


def test_gtsam_pgo_fixture_matches_salve_tpu():
    """5-pose square with loop closure + 1 unknown camera (tests/algorithms/test_pose2_slam.py)."""
    init = [None, Pose2(0.5, 0.0, 0.2), Pose2(2.3, 0.1, -0.2), Pose2(4.1, 0.1, math.pi / 2),
            Pose2(4.0, 2.0, math.pi), Pose2(2.1, 2.1, -math.pi / 2)]
    odo = [(1, 2, Pose2(2, 0, 0).inverse()), (2, 3, Pose2(2, 0, math.pi / 2).inverse()),
           (3, 4, Pose2(2, 0, math.pi / 2).inverse()), (4, 5, Pose2(2, 0, math.pi / 2).inverse()),
           (2, 5, Pose2(2, 0, math.pi / 2))]
    for robust in (False, True):
        (got, lms), (want, jlms) = _both(init, odo, {}, [], True, robust)
        _assert_poses_close(got, want, 1e-8)
        assert lms == jlms == {}
    assert abs(got[2].x - 2.0) < 1e-6 and abs(math.sin(got[4].theta - math.pi)) < 1e-6


def test_gtsam_landmark_fixture_matches_salve_tpu():
    init = [None, Pose2(-0.25, 0.20, 0.15), Pose2(2.30, 0.10, -0.20), Pose2(4.10, 0.10, 0.10)]
    odo = [(1, 2, Pose2(-2.0, 0.0, 0.0)), (2, 3, Pose2(-2.0, 0.0, 0.0))]
    lms = {1: np.array([1.80, 2.10]), 2: np.array([4.10, 1.80])}
    brms = [(1, 1, 45, np.sqrt(8.0)), (2, 1, 90, 2), (3, 2, 90, 2)]
    (got, glms), (want, wlms) = _both(init, odo, lms, brms, False)
    _assert_poses_close(got, want, 1e-8)
    assert glms.keys() == wlms.keys() == {1, 2}
    for k in glms:
        np.testing.assert_allclose(glms[k], wlms[k], rtol=0, atol=1e-8)
    np.testing.assert_allclose(glms[1], [2.0, 2.0], atol=1e-6)


def test_measurements_beyond_the_list_and_unlocalized():
    init = [Pose2(0.0, 0.0, 0.0), Pose2(2.1, 0.0, 0.0)]
    odo = [(0, 1, Pose2(2.0, 0.0, 0.0).inverse()), (1, 7, Pose2(2.0, 0.0, 0.0).inverse())]
    (got, _), (want, _) = _both(init, odo, {}, [], True, robust=False)
    _assert_poses_close(got, want, 1e-8)
    assert slam.planar_slam([None, None], [], {}, [], True, device="cpu") == ([None, None], {})


def _floor_graph(seed, zero_prior):
    """A floor-sized graph (16 poses, about 60 between factors): measured
    relative poses from true ones with noise, initial poses perturbed."""
    rng = np.random.default_rng(seed)
    n = 16
    true = np.concatenate([rng.uniform(-8, 8, (n, 2)), rng.uniform(-np.pi, np.pi, (n, 1))], 1)
    true[0] = 0.0
    odo = []
    for i1 in range(n):
        for i2 in range(i1 + 1, n):
            if rng.uniform() < 0.5:
                rel = Pose2(*true[i2]).between(Pose2(*true[i1]))
                odo.append((i1, i2, Pose2(rel.x + rng.normal(0, 0.02), rel.y + rng.normal(0, 0.02),
                                          rel.theta + rng.normal(0, 0.01))))
    init = true + np.concatenate([rng.normal(0, 0.2, (n, 2)), rng.normal(0, 0.05, (n, 1))], 1)
    if zero_prior:
        init[0] = 0.0
    return [Pose2(*p) for p in init], odo


def test_floor_sized_graph_with_a_nonzero_prior_moves_and_matches():
    init, odo = _floor_graph(3, zero_prior=False)
    (got, _), (want, _) = _both(init, odo, {}, [], True)
    _assert_poses_close(got, want, 1e-8)
    assert max(abs(g.x - i.x) for g, i in zip(got, init)) > 0.05


def test_identity_prior_floor_returns_salve_tpus_poses_bit_for_bit():
    """Stage D's case: the spanning tree's origin is the identity, the LM
    rejects every step, and both packages return the initial poses."""
    init, odo = _floor_graph(4, zero_prior=True)
    (got, _), (want, _) = _both(init, odo, {}, [], True)
    assert [tuple(g) for g in got] == [tuple(w) for w in want] == [tuple(p) for p in init]

    # Through the Sim(2) wrapper, as run_sfm calls it.
    wSi = [None if p is None else Sim2.from_theta_deg(math.degrees(p.theta), np.array([p.x, p.y])) for p in init]
    jwSi = [None if p is None else JaxSim2.from_theta_deg(math.degrees(p.theta), np.array([p.x, p.y]))
            for p in init]
    meas = [SimpleNamespace(i1=i1, i2=i2, i2Si1=Sim2.from_theta_deg(math.degrees(m.theta), np.array([m.x, m.y])))
            for i1, i2, m in odo]
    jmeas = [SimpleNamespace(i1=m.i1, i2=m.i2, i2Si1=JaxSim2(m.i2Si1.rotation, m.i2Si1.translation, 1.0))
             for m in meas]
    got = slam.execute_planar_slam(meas, wSi, device="cpu")
    want = jslam.execute_planar_slam(jmeas, jwSi)
    for g, w in zip(got, want):
        assert g.rotation.tobytes() == w.rotation.tobytes() and g.translation.tobytes() == w.translation.tobytes()
