"""The port's batched RANSAC Sim(3) pose alignment against salve_tpu (CPU).

Both sides fit in float32, and the port reproduces the jitted reference's
arithmetic as XLA:CPU compiles it: glibc's float32 sin, cos and atan2
(`ops/libm.py`), single-rounded FMAs where XLA fuses a product into an add,
and each sum's add order for the pose count (`ops/xla_sum.py`, measured by
`derive_xla_sum_orders.py`). So the per-hypothesis outputs are equal bit for
bit, the sequential rule picks the same winner even under near-ties, and
the aligned poses are equal."""

import json
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from salve_tpu_torch.ops import libm, xla_sum
from salve_tpu_torch.ops.numerics import fma_f32_exact
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


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
    """All five per-hypothesis outputs, bit for bit."""
    for name, a, b in zip(("mean_rot", "mean_trans", "theta", "t", "s"), got, want):
        assert np.array_equal(a.view(np.int32), b.view(np.int32)), name


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
    _assert_same_alignment(result, jpose_alignment.ransac_align_poses_sim3_ignore_missing(_jax(ref), _jax(est)), 0.0)
    # The winner recovers the known transform despite the outliers.
    assert abs(result[1].s - known.s) < 0.02
    np.testing.assert_allclose(result[1].R, known.R, atol=0.02)


@pytest.mark.parametrize("seed", [4, 5])
def test_ransac_without_outliers_agrees_within_tolerance(seed):
    """Near-ties: every hypothesis fits about as well, and rounding decides
    the winner; the port still picks the reference's."""
    ref = _floor_poses(seed)
    est, _ = _estimate(ref, seed, n_outliers=0, noise=0.001)
    got, want, winner, jwinner = _errors_and_winners(ref, est)
    _assert_errors_close(got, want)
    assert winner == jwinner
    _assert_same_alignment(
        pose_alignment.ransac_align_poses_sim3_ignore_missing(ref, est, device="cpu"),
        jpose_alignment.ransac_align_poses_sim3_ignore_missing(_jax(ref), _jax(est)),
        0.0,
    )


def test_single_fit_fallback_and_pose_errors_match():
    ref = _floor_poses(6)
    est, _ = _estimate(ref, 6, n_outliers=1, noise=0.01)
    got = pose_alignment.align_poses_sim3_ignore_missing(ref, est, device="cpu")
    want = jpose_alignment.align_poses_sim3_ignore_missing(_jax(ref), _jax(est))
    _assert_same_alignment(got, want, 0.0)
    # Two valid poses: too few to delete a third of, so RANSAC falls back.
    few = [p if i in (1, 2) else None for i, p in enumerate(est)]
    _assert_same_alignment(
        pose_alignment.ransac_align_poses_sim3_ignore_missing(ref, few, device="cpu"),
        jpose_alignment.ransac_align_poses_sim3_ignore_missing(_jax(ref), _jax(few)),
        0.0,
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
    assert got[:2] == want[:2]
    aligned, _ = est.align_by_Sim3_to_ref_pose_graph(gt, device="cpu")
    jaligned, _ = jest.align_by_Sim3_to_ref_pose_graph(jgt)
    for i in aligned.nodes:
        a, j = aligned.nodes[i].global_Sim2_local, jaligned.nodes[i].global_Sim2_local
        assert np.array_equal(a.rotation, j.rotation) and np.array_equal(a.translation, j.translation)
    assert est.measure_avg_abs_rotation_err(gt) == jest.measure_avg_abs_rotation_err(jgt)
    edges = [(i1, i2) for i1 in gt.nodes for i2 in gt.nodes if i1 < i2]
    assert est.measure_avg_rel_rotation_err(gt, edges) == jest.measure_avg_rel_rotation_err(jgt, edges)


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.int32)


@pytest.mark.parametrize("name", ["sin", "cos"])
def test_sinf_cosf_match_xla(name):
    """glibc's sequences, as XLA:CPU calls them, over the range the scorer
    feeds them (|x| < 3 pi) and past it, near multiples of pi/2, and tiny."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.uniform(-12, 12, 400_000), rng.uniform(-0.8, 0.8, 100_000), rng.uniform(-119.9, 119.9, 100_000),
        (np.pi / 2) * rng.integers(-7, 8, 100_000) + rng.normal(scale=1e-5, size=100_000),
        rng.normal(scale=1e-4, size=10_000), [0.0, -0.0, 0.75, -0.75, 2.0 ** -12, 119.99],
    ]).astype(np.float32)
    got = getattr(libm, name + "f")(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(getattr(jnp, name))(x))
    assert np.array_equal(_bits(got), _bits(want))
    assert np.isnan(getattr(libm, name + "f")(torch.tensor([120.0, np.inf, np.nan])).numpy()).all()


def test_atan2f_matches_xla():
    rng = np.random.default_rng(1)
    th = rng.uniform(-10, 10, 200_000)
    y = np.concatenate([rng.normal(size=300_000), np.sin(th), rng.normal(size=1000) * 1e-6]).astype(np.float32)
    x = np.concatenate([rng.normal(size=300_000), np.cos(th), np.ones(1000)]).astype(np.float32)
    special = np.array([0.0, -0.0, 1.0, -1.0, 3.0, -3.0, np.inf, -np.inf, np.nan, 1e30, -1e30], np.float32)
    sy, sx = (a.ravel() for a in np.meshgrid(special, special))
    y, x = np.concatenate([y, sy]), np.concatenate([x, sx])
    got = libm.atan2f(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jnp.arctan2)(y, x))
    same = (_bits(got) == _bits(want)) | (np.isnan(got) & np.isnan(want))
    assert same.all(), (y[~same][:5], x[~same][:5])


def _round_to_f32(q: Fraction) -> np.float32:
    """Round an exact rational to the nearest float32, ties to even."""
    near = np.float32(float(q))
    cands = [np.nextafter(near, np.float32(-np.inf)), near, np.nextafter(near, np.float32(np.inf))]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - q), int(np.array(v).view(np.int32)) & 1))


def test_fma_f32_exact_rounds_once():
    """Random triples, and triples whose float64 sum lands on a float32
    midpoint, against the exact rational rounded once."""
    rng = np.random.default_rng(2)
    a = rng.normal(size=3000).astype(np.float32)
    b = rng.normal(size=3000).astype(np.float32)
    c = rng.normal(size=3000).astype(np.float32)
    # Midpoint cases: c = -(a*b) rounded to float32, plus a tiny tail.
    m = np.float32(1.0) + np.float32(2.0 ** -23)
    a = np.concatenate([a, np.full(4, m, np.float32)])
    b = np.concatenate([b, np.array([m, -m, m, m], np.float32)])
    c = np.concatenate([c, np.array([2.0 ** -24, -(2.0 ** -24), 2.0 ** -48, -(2.0 ** -48)], np.float32)])
    got = fma_f32_exact(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    want = np.array([_round_to_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    assert np.array_equal(_bits(got), _bits(want))


def test_ordered_sum_plans():
    """The plan forms against hand-written add orders."""
    x = torch.tensor(np.random.default_rng(3).normal(size=(5, 20)).astype(np.float32)) * 1e3
    c = [x[:, k] for k in range(20)]
    seq = c[0] + 0.0
    for v in c[1:]:
        seq = seq + v
    assert torch.equal(xla_sum.ordered_sum(x), seq)
    # vf 4, ic 2 over 16, then the rest in order.
    lanes = [(c[l] + c[8 + l]) + (c[4 + l] + c[12 + l]) for l in range(4)]
    want = (lanes[0] + lanes[2]) + (lanes[1] + lanes[3])
    for v in c[16:]:
        want = want + v
    assert torch.equal(xla_sum.ordered_sum(x, -1, {"stages": [[4, 2, 16]]}), want)
    # The folded form: part 0 in order, then part 1 at steps 1, 0.
    lanes = [((c[l] + c[8 + l]) + c[12 + l]) + c[4 + l] for l in range(4)]
    want = (lanes[0] + lanes[2]) + (lanes[1] + lanes[3])
    for v in c[16:]:
        want = want + v
    assert torch.equal(xla_sum.ordered_sum(x, -1, {"stages": [[4, 2, 16, 1]]}), want)
    # Windows of 8 with padding 2 + 2: each window in order, then the sums.
    padded = torch.nn.functional.pad(x, (2, 2))
    win = [xla_sum.ordered_sum(padded[:, 8 * w: 8 * w + 8]) for w in range(3)]
    want = (win[0] + 0.0 + win[1]) + win[2]
    assert torch.equal(xla_sum.ordered_sum(x, -1, {"window": 8, "pad": [2, 2], "inner": [], "outer": []}), want)


def _scorer_inputs(n, rng, near):
    ta = rng.uniform(-np.pi, np.pi, n)
    rot = rng.uniform(-np.pi, np.pi)
    tb = np.arctan2(np.sin(ta - rot), np.cos(ta - rot)) + rng.normal(scale=1e-7 if near else 0.05, size=n)
    ca = np.c_[rng.uniform(-10, 10, (n, 2)), np.zeros(n)]
    c, s = np.cos(rot), np.sin(rot)
    cb = np.c_[(ca[:, :2] - 0.4) @ np.array([[c, s], [-s, c]]).T / 1.3, np.zeros(n)]
    cb[:, :2] += rng.normal(scale=1e-6 if near else 0.05, size=(n, 2))
    valid = rng.uniform(size=n) > 0.1
    valid[:3] = True
    keep = pose_alignment.ransac_keep_masks(valid, 1000, pose_alignment.DEFAULT_RANSAC_ALIGNMENT_DELETE_FRAC, n)
    return ta, ca, tb, cb, valid, keep


# Pose counts whose add orders differ in kind: plain loops, 2- and 4-lane
# interleaving, narrower epilogues, the folded form, and windows of 32.
SCORER_NS = [3, 8, 12, 13, 16, 17, 20, 22, 24, 28, 30, 32, 33, 40, 64]


@pytest.mark.parametrize("n", SCORER_NS)
def test_scorer_is_bit_exact(n):
    """The hypothesis scorer equals the jitted reference bit for bit at each
    pose count, on noisy and on near-exact poses."""
    rng = np.random.default_rng(n)
    for near in (False, True):
        inputs = _scorer_inputs(n, rng, near)
        got = [x.numpy() for x in pose_alignment._ransac_errors(*(pose_alignment._f32(x, "cpu") for x in inputs))]
        want = [np.asarray(x) for x in jpose_alignment._ransac_errors(
            *(jnp.asarray(x, dtype=jnp.float32) for x in inputs))]
        _assert_errors_close(got, want)
