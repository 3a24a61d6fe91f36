"""The port's batched RANSAC Sim(3) pose alignment against salve_tpu (CPU).

Both sides fit in float32. The RANSAC winner is picked by a sequential rule
on the hypotheses' mean errors, so under near-ties an ulp of sin/cos/atan2
can pick another iteration: on data with outliers, where the winner is
clear, the winning index must be the same; everywhere, the per-hypothesis
mean errors agree within 1e-5 and the aligned poses within 1e-4. The mean
rotation error is held in radians: XLA's and torch's float32 sin/cos differ
by an ulp on some inputs, which moves a fitted angle near pi by one ulp
(2.4e-7 rad), and that is 1.4e-5 in degrees.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest

from salve_tpu.algorithms import pose_alignment as jpose_alignment
from salve_tpu.common import posegraph2d as jposegraph2d
from salve_tpu.geometry.poses import Pose3 as JaxPose3
from salve_tpu.geometry.sim2 import Sim2 as JaxSim2
from salve_tpu_torch.algorithms import pose_alignment
from salve_tpu_torch.common import posegraph2d
from salve_tpu_torch.common.pano_data import FloorData
from salve_tpu_torch.dataset import procedural
from salve_tpu_torch.geometry.poses import Pose3, Sim3
from salve_tpu_torch.geometry.sim2 import Sim2


def _floor_poses(seed):
    """GT poses of one procedural floor, lifted to 3D, indexed by pano id."""
    b = procedural.generate_building_json(seed=seed, n_rows=4, n_cols=4)
    fd = FloorData.from_json(b["merger"]["floor_01"], "floor_01")
    poses = [None] * (max(p.id for p in fd.panos) + 1)
    for p in fd.panos:
        poses[p.id] = Pose3.from_rot2_trans2(p.global_Sim2_local.rotation.astype(np.float64),
                                             p.global_Sim2_local.translation.astype(np.float64))
    return poses


def _estimate(poses, seed, n_outliers, noise):
    """The poses seen through a known Sim(3), with noise, some outliers and a
    missing pose: returns (estimates, known aSb)."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(-np.pi, np.pi)
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])
    aSb = Sim3(R, np.array([*rng.uniform(-2, 2, 2), 0.0]), float(rng.uniform(0.5, 2.0)))
    bSa_R, bSa_s = R.T, 1.0 / aSb.s
    est = []
    for i, p in enumerate(poses):
        if p is None:
            est.append(None)
            continue
        # b-frame pose whose image under aSb is p: bRc = R^T aRc, btc = R^T (atc / s - t).
        Rb = bSa_R @ p.R
        tb = bSa_R @ (p.t * bSa_s - aSb.t)
        dth = rng.normal(0, noise)
        Rn = np.array([[np.cos(dth), -np.sin(dth), 0], [np.sin(dth), np.cos(dth), 0], [0, 0, 1.0]])
        tb = tb + np.array([*rng.normal(0, noise, 2), 0.0])
        est.append(Pose3(Rn @ Rb, tb))
    live = [i for i, p in enumerate(est) if p is not None]
    for i in rng.choice(live, n_outliers, replace=False):
        est[i] = Pose3(est[i].R, est[i].t + np.array([*rng.uniform(-3, 3, 2), 0.0]))
    est[live[-1]] = None
    return est, aSb


def _jax(poses):
    return [None if p is None else JaxPose3(p.R, p.t) for p in poses]


def _errors_and_winners(ref, est):
    """Per-hypothesis errors of both sides on the same keep-masks, and each
    side's winner by the sequential rule."""
    theta_a, ca, va = pose_alignment._planar_params(ref)
    theta_b, cb, vb = pose_alignment._planar_params(est)
    valid = va & vb
    keep = pose_alignment.ransac_keep_masks(valid, 1000, pose_alignment.DEFAULT_RANSAC_ALIGNMENT_DELETE_FRAC, 0)
    inputs = (theta_a, ca, theta_b, cb, valid, keep)
    got = [x.numpy() for x in pose_alignment._ransac_errors(*(pose_alignment._f32(x, "cpu") for x in inputs))]
    want = [np.asarray(x) for x in jpose_alignment._ransac_errors(*(jnp.asarray(x, dtype=jnp.float32) for x in inputs))]
    return got, want, pose_alignment.ransac_winner(got[0], got[1]), pose_alignment.ransac_winner(want[0], want[1])


def _assert_errors_close(got, want):
    np.testing.assert_allclose(np.deg2rad(got[0]), np.deg2rad(want[0]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)


def _assert_same_alignment(got, want, atol):
    (aligned, aSb), (jaligned, jaSb) = got, want
    for p, q in zip(aligned, jaligned):
        assert (p is None) == (q is None)
        if p is not None:
            np.testing.assert_allclose(p.R, q.R, rtol=0, atol=atol)
            np.testing.assert_allclose(p.t, q.t, rtol=0, atol=atol)
    np.testing.assert_allclose(aSb.R, jaSb.R, rtol=0, atol=atol)
    np.testing.assert_allclose(aSb.t, jaSb.t, rtol=0, atol=atol)
    assert abs(aSb.s - jaSb.s) <= atol


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ransac_picks_the_same_winner_on_outlier_data(seed):
    ref = _floor_poses(seed)
    est, known = _estimate(ref, seed, n_outliers=3, noise=0.01)
    got, want, winner, jwinner = _errors_and_winners(ref, est)
    assert winner == jwinner
    _assert_errors_close(got, want)
    result = pose_alignment.ransac_align_poses_sim3_ignore_missing(ref, est, device="cpu")
    _assert_same_alignment(result, jpose_alignment.ransac_align_poses_sim3_ignore_missing(_jax(ref), _jax(est)), 1e-4)
    # The winner recovers the known transform despite the outliers.
    assert abs(result[1].s - known.s) < 0.02
    np.testing.assert_allclose(result[1].R, known.R, atol=0.02)


@pytest.mark.parametrize("seed", [4, 5])
def test_ransac_without_outliers_agrees_within_tolerance(seed):
    """Near-ties: every hypothesis fits about as well, so only the errors
    and the aligned poses are held, not the index."""
    ref = _floor_poses(seed)
    est, _ = _estimate(ref, seed, n_outliers=0, noise=0.001)
    got, want, _, _ = _errors_and_winners(ref, est)
    _assert_errors_close(got, want)
    _assert_same_alignment(
        pose_alignment.ransac_align_poses_sim3_ignore_missing(ref, est, device="cpu"),
        jpose_alignment.ransac_align_poses_sim3_ignore_missing(_jax(ref), _jax(est)),
        1e-4,
    )


def test_single_fit_fallback_and_pose_errors_match():
    ref = _floor_poses(6)
    est, _ = _estimate(ref, 6, n_outliers=1, noise=0.01)
    got = pose_alignment.align_poses_sim3_ignore_missing(ref, est, device="cpu")
    want = jpose_alignment.align_poses_sim3_ignore_missing(_jax(ref), _jax(est))
    _assert_same_alignment(got, want, 1e-4)
    # Two valid poses: too few to delete a third of, so RANSAC falls back.
    few = [p if i in (1, 2) else None for i, p in enumerate(est)]
    _assert_same_alignment(
        pose_alignment.ransac_align_poses_sim3_ignore_missing(ref, few, device="cpu"),
        jpose_alignment.ransac_align_poses_sim3_ignore_missing(_jax(ref), _jax(few)),
        1e-4,
    )
    assert pose_alignment.align_poses_sim3_ignore_missing(ref, [None] * len(ref), device="cpu")[1].s == 1.0
    e, je = (m.compute_pose_errors_3d(ref, got[0]) for m in (pose_alignment, jpose_alignment))
    assert e[:2] == je[:2] and np.array_equal(e[2], je[2]) and np.array_equal(e[3], je[3])


def test_posegraph_alignment_and_errors_match(tmp_path):
    """posegraph2d's Sim(3) alignment to a reference graph, and its error
    measures, through the port's batched RANSAC."""
    b = procedural.generate_building_json(seed=7, n_rows=4, n_cols=4)
    raw = tmp_path / "zind" / "0007"
    raw.mkdir(parents=True)
    (raw / "zind_data.json").write_text(json.dumps(b))
    gt = posegraph2d.get_gt_pose_graph("0007", "floor_01", str(tmp_path / "zind"))
    jgt = jposegraph2d.get_gt_pose_graph("0007", "floor_01", str(tmp_path / "zind"))
    rng = np.random.default_rng(7)
    wSi = [None] * (max(gt.nodes) + 1)
    for i, p in gt.nodes.items():
        th = np.deg2rad(p.global_Sim2_local.theta_deg + 30.0 + rng.normal(0, 0.5))
        wSi[i] = (th, p.global_Sim2_local.translation * 1.5 + 0.3 + rng.normal(0, 0.01, 2))
    est = posegraph2d.PoseGraph2d.from_wSi_list(
        [None if w is None else Sim2.from_theta_deg(np.rad2deg(w[0]), w[1]) for w in wSi], gt)
    jest = jposegraph2d.PoseGraph2d.from_wSi_list(
        [None if w is None else JaxSim2.from_theta_deg(np.rad2deg(w[0]), w[1]) for w in wSi], jgt)
    got = est.measure_unaligned_abs_pose_error(gt, device="cpu")
    want = jest.measure_unaligned_abs_pose_error(jgt)
    assert abs(got[0] - want[0]) < 1e-4 and abs(got[1] - want[1]) < 1e-4
    aligned, _ = est.align_by_Sim3_to_ref_pose_graph(gt, device="cpu")
    jaligned, _ = jest.align_by_Sim3_to_ref_pose_graph(jgt)
    for i in aligned.nodes:
        a, j = aligned.nodes[i].global_Sim2_local, jaligned.nodes[i].global_Sim2_local
        np.testing.assert_allclose(a.rotation, j.rotation, atol=1e-4)
        np.testing.assert_allclose(a.translation, j.translation, atol=1e-4)
    assert est.measure_avg_abs_rotation_err(gt) == jest.measure_avg_abs_rotation_err(jgt)
    edges = [(i1, i2) for i1 in gt.nodes for i2 in gt.nodes if i1 < i2]
    assert est.measure_avg_rel_rotation_err(gt, edges) == jest.measure_avg_rel_rotation_err(jgt, edges)
