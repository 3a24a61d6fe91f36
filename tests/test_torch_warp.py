"""Sim(2) bank warps (kernel B3's plain version) against salve_tpu.

The shear warp's integer pass parameters and its output must equal the
JAX package's (the XLA oracle and the Pallas v2 kernel in interpret mode)
on the cases of tests/ops/test_pallas_warp.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salve_tpu.ops import warp as jwarp
from salve_tpu.ops.pallas_warp import warp_bank_sim2_shear_pallas_v2
from salve_tpu_torch.ops import warp as twarp

CASES = [
    (0.0, (0.0, 0.0)),
    (0.0, (0.17, -0.09)),
    (31.0, (0.17, -0.09)),
    (90.0, (0.5, -0.3)),
    (117.0, (-0.2, 0.05)),
    (205.0, (0.3, 0.1)),
    (-45.0, (0.03, 0.03)),
]
S_PX, DST_PX, MPP = 201, 100, 0.02


def _rot(deg):
    th = np.deg2rad(deg)
    return np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]], np.float32)


def _bank(seed, b=1):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 256, (b, S_PX, S_PX, 3)).astype(np.uint8)
    src[:, :40] = 0  # empty region, like real renders
    return src


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _jax_starts(R, t, s_px, dst_px, mpp):
    """JAX's integer pass parameters (salve_tpu/ops/pallas_warp.py:461-479),
    compiled as the JAX package compiles them."""
    d = dst_px + 1
    half_dst = int((dst_px / 2) * mpp)
    half_src = int(((s_px - 1) / 2) * mpp)
    x3 = d + int(np.ceil(jwarp._TAN22 * (d - 1)))
    y2 = d + int(np.ceil(jwarp._SIN45 * (x3 - 1)))
    n, a, sh, phi, b2 = jwarp._shear_params(jnp.asarray(R), jnp.asarray(t), half_src, half_dst, mpp)
    b2 = b2 + jwarp._q_center_correction(n, phi, (d - 1) / 2.0)
    o3 = jnp.minimum(0, jnp.round(a * (d - 1))).astype(jnp.int32)
    x3_log = jnp.arange(x3, dtype=jnp.float32)[None, :] + o3[:, None]
    r2 = jnp.round(sh[:, None] * x3_log).astype(jnp.int32)
    o2 = jnp.minimum(0, jnp.min(r2, axis=1))
    y2_log = jnp.arange(y2, dtype=jnp.float32)[None, :] + o2[:, None]
    row0 = (y2_log[:, 0] + jnp.round(b2[:, 1])).astype(jnp.int32)
    starts1 = (o3[:, None] + jnp.round(a[:, None] * y2_log + b2[:, 0:1])).astype(jnp.int32)
    starts2 = r2 - o2[:, None]
    v_idx = jnp.arange(d, dtype=jnp.float32)[None, :]
    starts3 = (jnp.round(a[:, None] * v_idx) - o3[:, None]).astype(jnp.int32)
    return dict(n=n, row0=row0, starts1=starts1, starts2=starts2, starts3=starts3)


@pytest.mark.parametrize("theta_deg,t", CASES)
def test_shear_params_and_output_match_jax(theta_deg, t):
    src = _bank(1)
    R = _rot(theta_deg)[None]
    tt = np.asarray(t, np.float32)[None]

    ref_p = _jax_starts(jnp.asarray(R), jnp.asarray(tt), S_PX, DST_PX, MPP)
    p = twarp.shear_warp_params(torch.from_numpy(R), torch.from_numpy(tt), S_PX, DST_PX, MPP)
    assert (p.y2, p.x3, p.d) == ref_p["starts1"].shape[1:] + ref_p["starts2"].shape[1:] + (DST_PX + 1,)
    for k, v in ref_p.items():
        np.testing.assert_array_equal(getattr(p, k).numpy(), np.asarray(v), err_msg=k)

    packed_j = jwarp.pack_rgb888(jnp.asarray(src))
    ref = np.asarray(jwarp.warp_bank_sim2_shear(packed_j, jnp.asarray(R), jnp.asarray(tt), dst_img_px=DST_PX))
    pallas = np.asarray(warp_bank_sim2_shear_pallas_v2(
        packed_j, jnp.asarray(R), jnp.asarray(tt), dst_img_px=DST_PX, interpret=True
    ))
    packed_t = twarp.pack_rgb888(torch.from_numpy(src))
    np.testing.assert_array_equal(packed_t.numpy(), np.asarray(packed_j))
    got = twarp.warp_bank_sim2_shear(packed_t, torch.from_numpy(R), torch.from_numpy(tt), dst_img_px=DST_PX).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pallas)
    assert got.any()


def test_shear_reads_bank_rows_in_place():
    """A (P, S, S) bank with a row index equals warping the gathered copy."""
    src = _bank(2, b=3)
    packed = twarp.pack_rgb888(torch.from_numpy(src))
    idx = torch.tensor([2, 0, 2, 1])
    R = torch.from_numpy(np.stack([_rot(a) for a in (10.0, 100.0, 200.0, 300.0)]))
    t = torch.tensor([[0.1, 0.2], [-0.3, 0.0], [0.0, 0.05], [0.2, -0.2]])
    got = twarp.warp_bank_sim2_shear(packed, R, t, DST_PX, MPP, bank_idx=idx)
    ref = twarp.warp_bank_sim2_shear(packed[idx], R, t, DST_PX, MPP)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    p = twarp.shear_warp_params(R, t, S_PX, DST_PX, MPP)
    assert sorted(set(p.n.tolist())) == [0, 1, 2, 3]  # every rot90 branch
    np.testing.assert_array_equal(twarp.shear_warp(packed, idx, p).numpy(), got.numpy())


def test_shear_reads_rows_outside_the_bank_as_empty():
    """B3 and its plain version agree on bank rows outside [0, P): zeros."""
    src = _bank(4, b=3)
    packed = twarp.pack_rgb888(torch.from_numpy(src))
    R = torch.from_numpy(np.stack([_rot(a) for a in (20.0, 20.0, 20.0, 20.0)]))
    t = torch.tensor([[0.1, 0.0]] * 4)
    p = twarp.shear_warp_params(R, t, S_PX, DST_PX, MPP)
    got = twarp.shear_warp(packed, torch.tensor([1, -1, 3, -4]), p).numpy()
    ref = twarp.shear_warp(packed, torch.tensor([1, 1, 1, 1]), p).numpy()
    assert got[0].any()
    np.testing.assert_array_equal(got[0], ref[0])
    assert not got[1:].any()


@pytest.mark.parametrize("theta_deg,t", CASES)
def test_nn_warp_matches_jax(theta_deg, t):
    """Equal, half-pixel ties included: (0, (0.17, -0.09)) puts every column
    on a .5 tie, which rounds the same way only because the port divides
    by a constant as the jitted JAX code does (ops/numerics.py)."""
    src = _bank(1)
    R = _rot(theta_deg)[None]
    tt = np.asarray(t, np.float32)[None]
    packed = twarp.pack_rgb888(torch.from_numpy(src))
    ref = np.asarray(jwarp.warp_bank_sim2_nn(
        jnp.asarray(packed.numpy()), jnp.asarray(R), jnp.asarray(tt), dst_img_px=DST_PX
    ))
    got = twarp.warp_bank_sim2_nn(packed, torch.from_numpy(R), torch.from_numpy(tt), dst_img_px=DST_PX).numpy()
    assert got.shape == ref.shape == (1, DST_PX + 1, DST_PX + 1, 3)
    np.testing.assert_array_equal(got, ref)


def test_warp_bank_auto_takes_the_nn_gather_on_cpu():
    src = _bank(3, b=2)
    packed = twarp.pack_rgb888(torch.from_numpy(src))
    R = torch.from_numpy(np.stack([_rot(33.0), _rot(-120.0)]))
    t = torch.tensor([[0.1, -0.2], [0.3, 0.3]])
    idx = torch.tensor([1, 0])
    got = twarp.warp_bank_auto(packed, R, t, DST_PX, MPP, bank_idx=idx)
    ref = twarp.warp_bank_sim2_nn(packed[idx], R, t, DST_PX, MPP)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
