"""Sim(2) bank warps (kernel B3's plain version) against salve_tpu.

The shear warp's integer pass parameters and its output must equal the
JAX package's (the XLA oracle and the Pallas v2 kernel in interpret mode)
on the cases of tests/ops/test_pallas_warp.py. A numpy model of the CUDA
kernel's schedule (csrc/warp.cu: T1 tiles, their rot90/flip-mapped output
rectangles, whole-word stores) is held to both as well.
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
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

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


TILE = 32  # csrc/warp.cu: kT, the side of a T1 tile


def _tile_rectangle(n, d, v0, u0, nv, nu):
    """Output rows [R0, R0 + nr) and columns [C0, C0 + nc) of a T1 tile, and
    the flat index base + r * dr + c * dc of the stored pixel (r, c) in the
    (32, 33) shared tile, as csrc/warp.cu maps them."""
    kp = TILE + 1
    nr, nc = (nv, nu) if n % 2 == 0 else (nu, nv)
    return nr, nc, {
        0: (d - v0 - nv, u0, (nv - 1) * kp, -kp, 1),
        1: (u0, v0, 0, 1, kp),
        2: (v0, d - u0 - nu, nu - 1, kp, -1),
        3: (d - u0 - nu, d - v0 - nv, (nv - 1) * kp + nu - 1, -1, -kp),
    }[n]


def _emulate_b3(bank, bank_idx, p):
    """csrc/warp.cu's schedule in numpy: T1 tile by tile in its (v, u) frame,
    each tile laid out as the bytes of its mapped output rectangle and
    stored row by row as whole 4-byte words, the bytes a word shares with the
    next tile one by one. Every output byte is written exactly once."""
    bank = bank.numpy()
    P, S, _ = bank.shape
    n_all, row0 = p.n.numpy(), p.row0.numpy()
    st1, st2, st3 = p.starts1.numpy(), p.starts2.numpy(), p.starts3.numpy()
    d = p.d
    nb = len(bank_idx)
    out = np.zeros(nb * d * d * 3, np.uint8)
    writes = np.zeros(out.size, np.int64)
    for b in range(nb):
        page = int(bank_idx[b])
        for v0 in range(0, d, TILE):
            for u0 in range(0, d, TILE):
                nv, nu = min(TILE, d - v0), min(TILE, d - u0)
                v = np.arange(v0, v0 + nv)[:, None]
                u = np.arange(u0, u0 + nu)[None, :]
                x = u + st3[b, v]  # pass 3
                ok = (x >= 0) & (x < p.x3)
                y = v + st2[b, np.clip(x, 0, p.x3 - 1)]  # pass 2
                ok &= (y >= 0) & (y < p.y2)
                sr = row0[b] + y  # pass 1
                sc = x + st1[b, np.clip(y, 0, p.y2 - 1)]
                ok &= (sr >= 0) & (sr < S) & (sc >= 0) & (sc < S) & (0 <= page < P)
                tile = np.zeros((TILE, TILE + 1), np.int64)
                tile[:nv, :nu] = np.where(
                    ok, bank[np.clip(page, 0, P - 1), S - 1 - np.clip(sr, 0, S - 1), np.clip(sc, 0, S - 1)], 0
                )
                flat = tile.reshape(-1)
                nr, nc, (R0, C0, base, dr, dc) = _tile_rectangle(int(n_all[b]), d, v0, u0, nv, nu)
                for r in range(nr):
                    B0 = 3 * ((b * d + R0 + r) * d + C0)
                    B1 = B0 + 3 * nc
                    row = np.zeros(3 * nc, np.uint8)  # the row segment's bytes
                    for c in range(nc):
                        px = int(flat[base + r * dr + c * dc])
                        row[3 * c:3 * c + 3] = [(px >> 16) & 0xFF, (px >> 8) & 0xFF, px & 0xFF]
                    W0, W1 = -(-B0 // 4) * 4, B1 // 4 * 4
                    words = range(W0, W1, 4) if W0 < W1 else range(0)
                    for wb in words:  # one whole word a lane
                        out[wb:wb + 4] = row[wb - B0:wb - B0 + 4]
                        writes[wb:wb + 4] += 1
                    edge = range(B0, B1) if not words else [*range(B0, W0), *range(W1, B1)]
                    for byte in edge:
                        out[byte] = row[byte - B0]
                        writes[byte] += 1
    assert (writes == 1).all()
    return out.reshape(nb, d, d, 3)


@pytest.mark.parametrize("theta_deg,t", CASES + [(-100.0, (0.1, 0.2))])
def test_kernel_tile_model_matches_plain_and_jax(theta_deg, t):
    """The model of B3's tiles equals the plain version and JAX; the extra
    case takes the rot90^1 branch, which CASES do not reach."""
    src = _bank(1)
    R = _rot(theta_deg)[None]
    tt = np.asarray(t, np.float32)[None]
    packed = twarp.pack_rgb888(torch.from_numpy(src))
    p = twarp.shear_warp_params(torch.from_numpy(R), torch.from_numpy(tt), S_PX, DST_PX, MPP)
    got = _emulate_b3(packed, torch.tensor([0]), p)
    np.testing.assert_array_equal(got, twarp.shear_warp_plain(packed, torch.tensor([0]), p).numpy())
    ref = np.asarray(jwarp.warp_bank_sim2_shear(
        jnp.asarray(packed.numpy()), jnp.asarray(R), jnp.asarray(tt), dst_img_px=DST_PX
    ))
    np.testing.assert_array_equal(got, ref)
    assert got.any()


def test_kernel_tile_model_covers_every_branch_and_rows_outside_the_bank():
    src = _bank(6, b=3)
    packed = twarp.pack_rgb888(torch.from_numpy(src))
    angles = (12.0, -100.0, 190.0, 95.0, 40.0, -170.0)
    R = torch.from_numpy(np.stack([_rot(a) for a in angles]))
    t = torch.tensor([[0.1, -0.1], [0.0, 0.2], [-0.2, 0.0], [0.05, 0.05], [0.0, 0.0], [0.1, 0.1]])
    idx = torch.tensor([2, 0, 1, 2, -1, 3])
    p = twarp.shear_warp_params(R, t, S_PX, DST_PX, MPP)
    assert sorted(set(p.n.tolist())) == [0, 1, 2, 3]
    got = _emulate_b3(packed, idx, p)
    np.testing.assert_array_equal(got, twarp.shear_warp_plain(packed, idx, p).numpy())
    assert got[:4].any() and not got[4:].any()


def test_pair_entry_on_cpu_equals_two_single_warps():
    ceil = twarp.pack_rgb888(torch.from_numpy(_bank(7, b=3)))
    floor = twarp.pack_rgb888(torch.from_numpy(_bank(8, b=3)))
    R = torch.from_numpy(np.stack([_rot(a) for a in (15.0, -100.0, 200.0)]))
    t = torch.tensor([[0.1, -0.2], [0.3, 0.3], [0.0, 0.1]])
    idx = torch.tensor([1, 0, 2])
    got = twarp.warp_banks_auto((ceil, floor), R, t, DST_PX, MPP, bank_idx=idx)
    assert len(got) == 2
    for g, bank in zip(got, (ceil, floor)):
        np.testing.assert_array_equal(g.numpy(), twarp.warp_bank_auto(bank, R, t, DST_PX, MPP, bank_idx=idx).numpy())
    assert not torch.equal(got[0], got[1])
