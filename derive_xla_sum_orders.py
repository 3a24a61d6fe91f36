"""Measure the add order of each sum in the JAX package's jitted RANSAC scorer.

The port's RANSAC (`salve_tpu_torch/algorithms/pose_alignment.py`) must give
the bits of `salve_tpu.algorithms.pose_alignment._ransac_errors` as XLA:CPU
compiles it, and the add order of its float32 sums changes with the pose
count n (LLVM's vectorizer picks lanes, interleaving and epilogues per trip
count; past 32, XLA cuts a sum into windows of 32). For each n this script
runs the compiled scorer on inputs that leave one sum's order free at a
time, and keeps the one plan of `salve_tpu_torch/ops/xla_sum.py`'s family
under which the port's arithmetic reproduces every hypothesis's output bits:

  S, C      the sums of w sin and w cos (compared: theta)
  den, num  the scale's sums, with dyadic centers so the centroid sums are
            exact in any order (compared: s)
  cb, ca    the centroid sums (compared: s, then s and t)
  rot, trans  the mean errors (compared: mean_rot, mean_trans)

It then checks the whole scorer on fresh noisy and near-exact inputs and
writes `salve_tpu_torch/ops/xla_sum_orders.json`. It runs JAX on the CPU:

    python derive_xla_sum_orders.py [--min_n 3] [--max_n 64] [--check_only]

`--check_only` derives nothing; a check that passes and continues the
checked range (`--min_n` at most `checked_to` + 1) raises `checked_to`.

The plans hold for the installed jaxlib on this CPU's instruction set; the
file records both.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import pathlib
import platform

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from salve_tpu.algorithms import pose_alignment as ref  # noqa: E402
from salve_tpu_torch.algorithms import pose_alignment as port  # noqa: E402
from salve_tpu_torch.ops import xla_sum  # noqa: E402
from salve_tpu_torch.ops.xla_sum import ordered_sum  # noqa: E402
from salve_tpu_torch.ops.libm import atan2f, cosf, sinf  # noqa: E402
from salve_tpu_torch.ops.numerics import fma_f32_exact  # noqa: E402

HYPOTHESES = 1000
OUT = pathlib.Path(__file__).parent / "salve_tpu_torch" / "ops" / "xla_sum_orders.json"


def _stage_lists(n: int):
    yield []
    for vf, ic in itertools.product((2, 4, 8, 16), (1, 2, 4)):
        step = vf * ic
        for c1 in range(step, n + 1, step):
            for first in ([[vf, ic, c1]], [[vf, ic, c1, 1]]) if ic == 2 else ([[vf, ic, c1]],):
                yield first
                for vf2 in (2, 4, 8):
                    for c2 in range(vf2, n - c1 + 1, vf2):
                        yield first + [[vf2, 1, c2]]


def candidates(n: int):
    for st in _stage_lists(n):
        yield {"stages": st}


def _inputs(n: int, rng, dyadic_a: bool = False, dyadic_b: bool = False, near: bool = False):
    ta = rng.uniform(-np.pi, np.pi, n)
    rot = rng.uniform(-np.pi, np.pi)
    tb = ta - rot + rng.normal(scale=1e-7 if near else 0.05, size=n)
    tb = np.arctan2(np.sin(tb), np.cos(tb))
    dy = lambda a: np.round(a * 8) / 8
    ca = np.c_[rng.uniform(-10, 10, (n, 2)), np.zeros(n)]
    cb = np.c_[rng.uniform(-6, 6, (n, 2)), np.zeros(n)]
    if near:
        c, s = np.cos(rot), np.sin(rot)
        cb = np.c_[(ca[:, :2] - rng.uniform(-1, 1, 2)) @ np.array([[c, s], [-s, c]]).T / 1.3, np.zeros(n)]
        cb[:, :2] += rng.normal(scale=1e-6, size=(n, 2))
    ca = dy(ca) if dyadic_a else ca
    cb = dy(cb) if dyadic_b else cb
    valid = rng.uniform(size=n) > 0.1
    valid[:3] = True
    keep = port.ransac_keep_masks(valid, HYPOTHESES, port.DEFAULT_RANSAC_ALIGNMENT_DELETE_FRAC, int(rng.integers(1 << 30)))
    return ta, ca, tb, cb, valid, keep


def _reference(ta, ca, tb, cb, valid, keep):
    outs = ref._ransac_errors(
        jnp.asarray(ta), jnp.asarray(ca), jnp.asarray(tb), jnp.asarray(cb),
        jnp.asarray(valid, dtype=jnp.float32), jnp.asarray(keep),
    )
    return [torch.from_numpy(np.array(o)) for o in outs]


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)))


class _Case:
    """One input set as float32 tensors, with the port's shared pieces."""

    def __init__(self, arrays):
        f = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32)
        self.ta, self.ca, self.tb, self.cb, valid, keep = (f(x) for x in arrays)
        self.w = keep * valid[None, :]
        self.nkept = ordered_sum(self.w, -1)
        self.dtheta = self.ta - self.tb

    def theta(self, plan_s, plan_c):
        w, d = self.w, self.dtheta
        return atan2f(ordered_sum(w * sinf(d), -1, plan_s), ordered_sum(w * cosf(d), -1, plan_c))

    def scale(self, R, cb_cent, ca_cent, plan_num, plan_den):
        w = self.w
        db = self.cb[None, :, :] - cb_cent[:, None, :]
        Rdb = port._matvec(R[:, None, :, :], db)
        num = ordered_sum(w * port._dot(self.ca[None, :, :] - ca_cent[:, None, :], Rdb), -1, plan_num)
        den = ordered_sum(w * port._dot(db, db), -1, plan_den)
        return port._scale(num, den)

    def cent(self, c, plan):
        return ordered_sum(c[None, :, :] * self.w[..., None], -2, plan)


def _search(n, name, test):
    hits = [p for p in candidates(n) if test(p)]
    if not hits:
        raise RuntimeError(f"n={n}: no plan reproduces the sum {name!r}")
    return hits[0]


def derive(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    plans: dict = {}
    get = lambda k: plans.get(k)

    arrays = _inputs(n, rng)
    _, _, theta_ref, _, _ = _reference(*arrays)
    case = _Case(arrays)
    p = _search(n, "S, C", lambda p: _same(case.theta(p, p), theta_ref))
    plans["S"] = plans["C"] = p

    # den and num: dyadic centers make both centroid sums exact.
    arrays = _inputs(n, rng, dyadic_a=True, dyadic_b=True)
    _, _, _, _, s_ref = _reference(*arrays)
    case = _Case(arrays)
    R = port._planar_rotation(case.theta(get("S"), get("C")))
    cb_cent = case.cent(case.cb, None) / case.nkept[:, None]
    ca_cent = case.cent(case.ca, None) / case.nkept[:, None]
    p = _search(n, "den, num", lambda p: _same(case.scale(R, cb_cent, ca_cent, p, p), s_ref))
    plans["den"] = plans["num"] = p

    arrays = _inputs(n, rng, dyadic_a=True)
    _, _, _, _, s_ref = _reference(*arrays)
    case = _Case(arrays)
    R = port._planar_rotation(case.theta(get("S"), get("C")))
    ca_cent = case.cent(case.ca, None) / case.nkept[:, None]
    plans["cb"] = _search(
        n, "cb",
        lambda p: _same(case.scale(R, case.cent(case.cb, p) / case.nkept[:, None], ca_cent, get("num"), get("den")), s_ref),
    )

    arrays = _inputs(n, rng)
    _, _, _, t_ref, s_ref = _reference(*arrays)
    case = _Case(arrays)
    R = port._planar_rotation(case.theta(get("S"), get("C")))
    cb_cent = case.cent(case.cb, get("cb")) / case.nkept[:, None]

    def ca_fits(p):
        ca_sum = case.cent(case.ca, p)
        s = case.scale(R, cb_cent, ca_sum / case.nkept[:, None], get("num"), get("den"))
        t = ca_sum / (case.nkept * s)[:, None] - port._matvec(R, cb_cent)
        return _same(s, s_ref) and _same(t, t_ref)

    plans["ca"] = _search(n, "ca", ca_fits)

    # The mean errors add finished per-pose errors: search them on those,
    # computed from the reference's own theta, t and s.
    arrays = _inputs(n, rng)
    rot_ref, trans_ref, theta, t, s = _reference(*arrays)
    case = _Case(arrays)
    d = case.dtheta[None, :] - theta[:, None]
    rot_err = torch.abs(atan2f(sinf(d), cosf(d)) * port._RAD2DEG)
    plans["rot"] = _search(n, "rot", lambda p: _same(ordered_sum(rot_err * case.w, -1, p) / case.nkept, rot_ref))
    Rcb = port._matvec(port._planar_rotation(theta)[:, None, :, :], case.cb[None, :, :])
    diff = fma_f32_exact(-s[:, None, None], Rcb + t[:, None, :], case.ca[None, :, :])
    trans_terms = port._sqrt(port._dot(diff, diff)) * case.w
    plans["trans"] = _search(n, "trans", lambda p: _same(ordered_sum(trans_terms, -1, p) / case.nkept, trans_ref))
    return plans


def check(n: int, seed: int, trials: int = 4) -> list:
    """Names of the outputs that differ from the reference on fresh inputs."""
    rng = np.random.default_rng(seed)
    bad = []
    for k in range(trials):
        arrays = _inputs(n, rng, near=k % 2 == 1)
        want = _reference(*arrays)
        f = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32)
        got = port._ransac_errors(*(f(x) for x in arrays))
        for name, a, b in zip(("mean_rot", "mean_trans", "theta", "t", "s"), got, want):
            if not _same(a, b):
                bad.append(f"{name}@{k}")
    return bad


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--min_n", type=int, default=3)
    parser.add_argument("--max_n", type=int, default=64)
    parser.add_argument("--check_only", action="store_true", help="check the stored plans, derive nothing")
    args = parser.parse_args(argv)
    table = xla_sum._table()
    failed = []
    for n in range(args.min_n, args.max_n + 1):
        measured = n < table["window_from"]
        if measured and not args.check_only:
            table["ransac_errors"].pop(str(n), None)
            try:
                table["ransac_errors"][str(n)] = derive(n, seed=n)
            except RuntimeError as err:
                print(err, flush=True)
                failed.append(n)
                continue
        bad = check(n, seed=10_000 + n)
        plans = xla_sum.ransac_plans(n)
        print(f"n={n}: {plans if measured else 'windowed'} -> {'ok' if not bad else 'DIFFERS ' + ' '.join(bad)}", flush=True)
        if bad:
            failed.append(n)
            if measured and not args.check_only:
                table["ransac_errors"].pop(str(n))
    if args.check_only and not failed and args.min_n <= table.get("checked_to", 0) + 1:
        # A clean check that continues the checked range extends it.
        table["checked_to"] = max(table["checked_to"], args.max_n)
        OUT.write_text(json.dumps(table, indent=1, sort_keys=True) + "\n")
    if not args.check_only:
        table["jaxlib"] = jax.__version__
        table["cpu"] = f"{platform.machine()} {torch.backends.cpu.get_cpu_capability()}"
        table["hypotheses"] = HYPOTHESES
        if not failed:
            table["checked_to"] = max(table.get("checked_to", 0), args.max_n)
        OUT.write_text(json.dumps(table, indent=1, sort_keys=True) + "\n")
    print("differs at n =", failed if failed else "none")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
