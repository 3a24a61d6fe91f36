"""Planar Pose(2) SLAM: robust Levenberg-Marquardt in float64 on the card.

Port of salve_tpu/algorithms/pose2_slam.py (itself the replacement for the
reference's GTSAM factor graph, salve/algorithms/pose2_slam.py:57-172): a
prior on the first localized pano, a between factor per verified edge,
optional bearing-range factors to W/D/O landmarks, Huber(1.345) robust
noise, Levenberg-Marquardt. The JAX package pins its solve to the host CPU
because the TPU has no float64 LU; the H100 computes in float64, so the LM
runs on `device` (None: the CUDA card).

The loop is MAX_LM_ITERS fixed iterations whose accept/reject is a
`torch.where` on the device, with `torch.linalg.solve_ex` (no error check),
so the host never waits for the card inside it (JAX's `solve` returns NaN
silently too).

The Jacobian is `torch.func.jacfwd` of the residual at a zero increment, as
JAX takes `jax.jacfwd`, with the forward-mode rules of JAX's primitives where
they differ from PyTorch's: a norm is sqrt(sum(r*r)) (whose derivative at
r = 0 is 0/0 = NaN, where `torch.linalg.vector_norm`'s is 0), and max/min
scale the tangent of each operand by its selection weight (1, 0, or 0.5 at a
tie), so a NaN tangent survives a branch that was not taken.

This reproduces a defect of the JAX package. On every Stage D floor the
spanning tree puts the origin pano at the identity and the prior sits on
that pano, so the prior's whitened residual is exactly zero; its Huber
weight's derivative is NaN there, every Jacobian row of the prior block is
NaN, J^T J and every step are NaN, `c_new < c_prev` is False and all 100
iterations are rejected: the LM returns its initial poses unchanged. The
port returns the same, as salve_tpu does (ROADMAP.md section C). A between
factor's block is NaN by the same rule when its residual is exactly zero;
where XLA:CPU contracts the composition into FMAs, such a residual can be
a few ulps off zero in salve_tpu and exactly zero here, which happens only
when initial poses reproduce a measurement to the last bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from salve_tpu_torch.device import DeviceLike, resolve_device
from salve_tpu_torch.geometry.pose2 import Pose2
from salve_tpu_torch.geometry.sim2 import Sim2

# Noise sigmas (parity: salve/algorithms/pose2_slam.py:20-22).
PRIOR_SIGMAS = np.array([0.3, 0.3, 0.1])
ODOMETRY_SIGMAS = np.array([0.2, 0.2, 0.1])
MEASUREMENT_SIGMAS = np.array([0.1, 0.2])  # (bearing rad, range)
HUBER_K = 1.345

MAX_LM_ITERS = 100
LAMBDA_INIT = 1e-5
LAMBDA_FACTOR = 10.0


@dataclass
class BearingRangeMeasurement:
    """Bearing-range measurement between camera and landmark (degrees)."""

    pano_id: int
    l_idx: int
    bearing_deg: float
    range: float


@dataclass
class OdometryMeasurement:
    """Relative pose measurement i2Ti1 between two panoramas."""

    i1: int
    i2: int
    i2Ti1: Pose2


def _wrap(theta: torch.Tensor) -> torch.Tensor:
    return torch.atan2(torch.sin(theta), torch.cos(theta))


def _compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compose (...,3) pose arrays."""
    c, s = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    return torch.stack(
        [
            a[..., 0] + c * b[..., 0] - s * b[..., 1],
            a[..., 1] + s * b[..., 0] + c * b[..., 1],
            _wrap(a[..., 2] + b[..., 2]),
        ],
        dim=-1,
    )


def _inverse(a: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    return torch.stack(
        [
            -(c * a[..., 0] + s * a[..., 1]),
            -(-s * a[..., 0] + c * a[..., 1]),
            -a[..., 2],
        ],
        dim=-1,
    )


def _norm(r: torch.Tensor, keepdim: bool) -> torch.Tensor:
    """jnp.linalg.norm over the last axis: sqrt(sum(r*r)), NaN derivative at 0."""
    return torch.sqrt(torch.sum(r * r, dim=-1, keepdim=keepdim))


def _max_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """jnp.maximum(x, c) for a constant c, with lax.max's JVP: x's tangent
    times 1 where x > c, 0.5 where x == c, 0 where x < c (so 0 * NaN = NaN)."""
    w = torch.where(x > c, 1.0, torch.where(x == c, 0.5, 0.0)).to(x.dtype)
    return x * w + c * (1.0 - w)


def _min_const(c: float, x: torch.Tensor) -> torch.Tensor:
    """jnp.minimum(c, x) for a constant c, with lax.min's JVP (as `_max_const`)."""
    w = torch.where(x < c, 1.0, torch.where(x == c, 0.5, 0.0)).to(x.dtype)
    return x * w + c * (1.0 - w)


def _robustify(r: torch.Tensor) -> torch.Tensor:
    """Huber: scale the whitened residual block by sqrt(min(1, k/|r|))."""
    norm = _norm(r, keepdim=True)
    w = torch.sqrt(_min_const(1.0, HUBER_K / _max_const(norm, 1e-12)))
    return r * w


def _residuals(
    poses: torch.Tensor,      # (N,3)
    landmarks: torch.Tensor,  # (L,2)
    odo_idx: torch.Tensor,    # (E,2) int64 (i1_idx, i2_idx)
    odo_meas: torch.Tensor,   # (E,3) i2Ti1
    prior_idx: int,
    brm_idx: torch.Tensor,    # (M,2) int64 (pose_idx, lm_idx)
    brm_meas: torch.Tensor,   # (M,2) (bearing_rad, range)
    use_robust: bool,
    sigmas: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],  # prior, odometry, measurement
) -> torch.Tensor:
    """Whitened, robustly-reweighted residuals of every factor, flattened
    (salve_tpu's `_residuals` without its all-ones validity masks)."""
    robustify = _robustify if use_robust else (lambda r: r)
    prior_sig, odo_sig, meas_sig = sigmas

    # Prior factor: chart of prior^-1 * x_origin with prior = identity.
    p = poses[prior_idx]
    r_prior = torch.stack([p[0] / prior_sig[0], p[1] / prior_sig[1], _wrap(p[2]) / prior_sig[2]])
    r_prior = robustify(r_prior)

    # Between factors: chart of m^-1 * (x_i2^-1 * x_i1).
    rel = _compose(_inverse(poses[odo_idx[:, 1]]), poses[odo_idx[:, 0]])
    err = _compose(_inverse(odo_meas), rel)
    err = torch.stack([err[:, 0], err[:, 1], _wrap(err[:, 2])], dim=-1)
    r_odo = robustify(err / odo_sig)

    # Bearing-range factors.
    x_p = poses[brm_idx[:, 0]]
    d = landmarks[brm_idx[:, 1]] - x_p[:, :2]
    c, s = torch.cos(x_p[:, 2]), torch.sin(x_p[:, 2])
    # Rotate into the pose frame: R(theta)^T d.
    local = torch.stack([c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1]], dim=-1)
    pred_bearing = torch.atan2(local[:, 1], local[:, 0])
    pred_range = _norm(local, keepdim=False)
    r_brm = torch.stack(
        [
            _wrap(pred_bearing - brm_meas[:, 0]) / meas_sig[0],
            (pred_range - brm_meas[:, 1]) / meas_sig[1],
        ],
        dim=-1,
    )
    r_brm = robustify(r_brm)

    return torch.cat([r_prior.reshape(-1), r_odo.reshape(-1), r_brm.reshape(-1)])


def _device_const(values, device: torch.device) -> torch.Tensor:
    """A float64 constant made on `device` by fill kernels: a copy from host
    memory would make the host wait for the card."""
    return torch.stack([torch.full((), float(v), dtype=torch.float64, device=device) for v in np.ravel(values)])


class _Problem:
    """The LM's state layout and functions for one factor graph."""

    def __init__(self, n_poses, n_lms, odo_idx, odo_meas, brm_idx, brm_meas, use_robust):
        self.n_poses, self.n_lms = n_poses, n_lms
        dev = odo_meas.device
        sigmas = tuple(_device_const(x, dev) for x in (PRIOR_SIGMAS, ODOMETRY_SIGMAS, MEASUREMENT_SIGMAS))
        self.args = (odo_idx, odo_meas, 0, brm_idx, brm_meas, use_robust, sigmas)

    def unpack(self, state):
        n = self.n_poses * 3
        return state[:n].reshape(self.n_poses, 3), state[n:].reshape(self.n_lms, 2)

    def retract(self, state, delta):
        """Pose blocks compose the increment; landmark blocks add."""
        poses, lms = self.unpack(state)
        dp, dl = self.unpack(delta)
        return torch.cat([_compose(poses, dp).reshape(-1), (lms + dl).reshape(-1)])

    def res_at(self, state):
        poses, lms = self.unpack(state)
        return _residuals(poses, lms, *self.args)

    def res_local(self, delta, state):
        return self.res_at(self.retract(state, delta))

    def cost(self, state):
        r = self.res_at(state)
        return 0.5 * torch.dot(r, r)

    def jacobian(self, state):
        """d res_local / d delta at delta = 0, as jax.jacfwd(res_local)(0, state)."""
        return torch.func.jacfwd(self.res_local)(torch.zeros_like(state), state)


def linearize(prob: _Problem, state):
    """(Jacobian, residuals) at `state`: what an LM step solves with."""
    return prob.jacobian(state), prob.res_at(state)


def lm_step(prob: _Problem, state, lam, c_prev, eye, linearized=None):
    """One Levenberg-Marquardt iteration; the accept/reject stays on the
    device. `linearized` is `linearize(prob, state)` where the caller holds
    it. Returns (state, lam, c_prev, accept)."""
    J, r = linearize(prob, state) if linearized is None else linearized
    A = J.T @ J + lam * eye
    g = J.T @ r
    delta = -torch.linalg.solve_ex(A, g)[0]
    new_state = prob.retract(state, delta)
    c_new = prob.cost(new_state)
    accept = c_new < c_prev
    state = torch.where(accept, new_state, state)
    lam = torch.where(accept, lam / LAMBDA_FACTOR, lam * LAMBDA_FACTOR)
    c_prev = torch.where(accept, c_new, c_prev)
    return state, lam, c_prev, accept


def lm_start(poses0, landmarks0, odo_idx, odo_meas, brm_idx, brm_meas, use_robust):
    """The problem and the loop's initial (state, lam, c_prev, eye)."""
    prob = _Problem(poses0.shape[0], landmarks0.shape[0], odo_idx, odo_meas, brm_idx, brm_meas, use_robust)
    state = torch.cat([poses0.reshape(-1), landmarks0.reshape(-1)])
    eye = torch.eye(state.shape[0], dtype=state.dtype, device=state.device)
    lam = torch.full((), LAMBDA_INIT, dtype=state.dtype, device=state.device)
    return prob, (state, lam, prob.cost(state), eye)


def lm_solve(
    poses0: torch.Tensor,
    landmarks0: torch.Tensor,
    odo_idx: torch.Tensor,
    odo_meas: torch.Tensor,
    brm_idx: torch.Tensor,
    brm_meas: torch.Tensor,
    use_robust: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Levenberg-Marquardt over the flattened (poses, landmarks) state, on
    the inputs' device; the prior is on pose 0. No host sync inside."""
    prob, (state, lam, c_prev, eye) = lm_start(poses0, landmarks0, odo_idx, odo_meas, brm_idx, brm_meas, use_robust)
    # A rejected step keeps the state, and with it the Jacobian and the
    # residuals. On the host the verdict costs nothing to read, so the CPU
    # linearizes again only after an accepted step (every step of a floor
    # whose prior residual is 0 is NaN and rejected); the card's loop never
    # waits for the verdict.
    on_host = state.device.type == "cpu"
    linearized = None
    for _ in range(MAX_LM_ITERS):
        if on_host and linearized is None:
            linearized = linearize(prob, state)
        state, lam, c_prev, accept = lm_step(prob, state, lam, c_prev, eye, linearized)
        if on_host and bool(accept):
            linearized = None
    return prob.unpack(state)


def factor_tables(
    wTi_list_init: List[Optional[Pose2]],
    i2Ti1_measurements: List[OdometryMeasurement],
    landmark_positions_init: Dict[int, np.ndarray],
    landmark_measurements: List[BearingRangeMeasurement],
    optimize_poses_only: bool,
    device: torch.device,
) -> Tuple[Tuple[torch.Tensor, ...], Dict[int, int], List[int]]:
    """`lm_solve`'s inputs on `device` (float64 states, int64 indices), the
    pano ID -> pose row map and the landmark IDs, for the localized panos."""
    n = len(wTi_list_init)
    est_ids = [i for i, p in enumerate(wTi_list_init) if p is not None]
    id2idx = {pid: k for k, pid in enumerate(est_ids)}
    poses0 = np.array(
        [[wTi_list_init[i].x, wTi_list_init[i].y, wTi_list_init[i].theta] for i in est_ids],
        dtype=np.float64,
    ).reshape(-1, 3)

    def _localized(pid: int) -> bool:
        # Edge-filtering stages can leave measurements referencing panos
        # beyond the spanning tree's range: treat them as un-localized.
        return pid < n and wTi_list_init[pid] is not None

    odo = [m for m in i2Ti1_measurements if _localized(m.i1) and _localized(m.i2)]
    odo_idx = np.array([[id2idx[m.i1], id2idx[m.i2]] for m in odo], dtype=np.int64).reshape(-1, 2)
    odo_meas = np.array([[m.i2Ti1.x, m.i2Ti1.y, m.i2Ti1.theta] for m in odo], dtype=np.float64).reshape(-1, 3)

    if optimize_poses_only:
        lm_ids, landmarks0 = [], np.zeros((0, 2))
        brm_idx = np.zeros((0, 2), dtype=np.int64)
        brm_meas = np.zeros((0, 2))
    else:
        lm_ids = sorted(landmark_positions_init.keys())
        lid2idx = {lid: k for k, lid in enumerate(lm_ids)}
        landmarks0 = np.array(
            [np.asarray(landmark_positions_init[lid], dtype=np.float64) for lid in lm_ids]
        ).reshape(-1, 2)
        brms = [b for b in landmark_measurements if _localized(b.pano_id)]
        brm_idx = np.array([[id2idx[b.pano_id], lid2idx[b.l_idx]] for b in brms], dtype=np.int64).reshape(-1, 2)
        brm_meas = np.array([[np.deg2rad(b.bearing_deg), b.range] for b in brms], dtype=np.float64).reshape(-1, 2)

    def f64(x):
        return torch.as_tensor(x, dtype=torch.float64, device=device)

    tables = (f64(poses0), f64(landmarks0), torch.as_tensor(odo_idx, device=device), f64(odo_meas),
              torch.as_tensor(brm_idx, device=device), f64(brm_meas))
    return tables, id2idx, lm_ids


def planar_slam(
    wTi_list_init: List[Optional[Pose2]],
    i2Ti1_measurements: List[OdometryMeasurement],
    landmark_positions_init: Dict[int, np.ndarray],
    landmark_measurements: List[BearingRangeMeasurement],
    optimize_poses_only: bool,
    use_robust: bool = True,
    device: DeviceLike = None,
) -> Tuple[List[Optional[Pose2]], Dict[int, np.ndarray]]:
    """Execute SLAM in the 2D plane (parity: pose2_slam.py:57), on `device`.

    Args:
        wTi_list_init: initial global poses (None = unlocalized, stays None).
        i2Ti1_measurements: odometry measurements.
        landmark_positions_init: landmark ID -> initial 2D position.
        landmark_measurements: bearing-range measurements to landmarks.
        optimize_poses_only: ignore landmarks (pure PGO).
        use_robust: Huber(1.345) robust loss on all factors.
        device: where the LM runs (None: the CUDA card; raises without one).

    Returns:
        (optimized poses with None preserved, landmark ID -> position).
    """
    dev = resolve_device(device)
    if all(p is None for p in wTi_list_init):
        return list(wTi_list_init), {}
    tables, id2idx, lm_ids = factor_tables(
        wTi_list_init, i2Ti1_measurements, landmark_positions_init, landmark_measurements,
        optimize_poses_only, dev,
    )
    poses_opt, lms_opt = (x.cpu().numpy() for x in lm_solve(*tables, use_robust))

    wTi_list: List[Optional[Pose2]] = [None] * len(wTi_list_init)
    for pid, k in id2idx.items():
        wTi_list[pid] = Pose2(*poses_opt[k])

    landmark_positions = {lid: lms_opt[k] for k, lid in enumerate(lm_ids)}
    return wTi_list, landmark_positions


def execute_planar_slam(
    measurements,
    wSi_list: List[Optional[Sim2]],
    per_edge_wdo_dict=None,
    inferred_floor_pose_graph=None,
    optimize_poses_only: bool = True,
    device: DeviceLike = None,
) -> List[Optional[Sim2]]:
    """Gather odometry (+ landmark) measurements, run SLAM, return Sim2 poses.

    Parity: pose2_slam.py:175-321 — odometry from verified edge measurements,
    pose initialization from the spanning tree (wSi_list), and (optionally)
    W/D/O endpoints as landmarks via data association.

    Args:
        measurements: EdgeClassification-like objects with .i1/.i2/.i2Si1.
        wSi_list: spanning-tree initialization of global poses.
        per_edge_wdo_dict: (i1,i2) -> EdgeWDOPair, needed for landmark SLAM.
        inferred_floor_pose_graph: layouts, needed for landmark SLAM.
        optimize_poses_only: PGO-only if True.
        device: where the LM runs (None: the CUDA card; raises without one).
    """
    dev = resolve_device(device)
    wTi_list_init = [
        Pose2.from_theta_deg(wSi.theta_deg, *wSi.translation) if wSi is not None else None
        for wSi in wSi_list
    ]

    i2Ti1_measurements = []
    for m in measurements:
        theta_rad = np.deg2rad(m.i2Si1.theta_deg)
        x, y = m.i2Si1.translation
        i2Ti1_measurements.append(OdometryMeasurement(m.i1, m.i2, Pose2(x, y, theta_rad)))

    landmark_positions_init: Dict[int, np.ndarray] = {}
    landmark_measurements: List[BearingRangeMeasurement] = []
    if not optimize_poses_only:
        from salve_tpu_torch.algorithms import data_association

        tracks = data_association.perform_data_association(
            measurements, per_edge_wdo_dict, inferred_floor_pose_graph
        )
        pano_dict = inferred_floor_pose_graph.nodes
        for l_idx, track in enumerate(tracks):
            for pano_id, kpt_idx in track:
                if wTi_list_init[pano_id] is None:
                    continue
                kpt = data_association.get_kpt_coordinate(pano_dict[pano_id], kpt_idx)
                bearing_deg = float(np.rad2deg(np.arctan2(kpt[1], kpt[0])))
                rng = float(np.linalg.norm(kpt))
                landmark_measurements.append(BearingRangeMeasurement(pano_id, l_idx, bearing_deg, rng))
                if l_idx not in landmark_positions_init:
                    wTi = wTi_list_init[pano_id]
                    landmark_positions_init[l_idx] = wTi.transform_from(np.asarray(kpt).reshape(1, 2)).squeeze()

    wTi_list, _ = planar_slam(
        wTi_list_init,
        i2Ti1_measurements,
        landmark_positions_init,
        landmark_measurements,
        optimize_poses_only=optimize_poses_only,
        use_robust=True,
        device=dev,
    )

    wSi_list_opt: List[Optional[Sim2]] = [None] * len(wSi_list)
    for i, wTi in enumerate(wTi_list):
        if wTi is None:
            continue
        wSi_list_opt[i] = Sim2(R=wTi.rotation_matrix(), t=wTi.translation(), s=1.0)
    return wSi_list_opt
