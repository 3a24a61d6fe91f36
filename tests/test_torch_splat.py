"""Plain z-order splat (kernel B1's plain version) against salve_tpu.

The splat is integer work once the pixel coordinates are fixed, so given the
same integer `xy_img` and `z` the priority grid, the sparse colours and the
occupancy must be equal. A numpy model of the CUDA kernel's schedule
(csrc/splat.cu: the -1 stripes, warps' windows of 128 points in rounds of
32 lanes, runs of equal cells merged into one atomic) is held to both as
well.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salve_tpu.ops import bev as jbev
from salve_tpu.ops.pallas_splat import splat_priority_grid_pallas
from salve_tpu_torch.ops import splat
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _points(seed, b=2, n=400, h=30, w=37):
    rng = np.random.default_rng(seed)
    xy = rng.integers(-3, max(h, w) + 3, (b, n, 2)).astype(np.int32)
    xy[:, : n // 4] = xy[:, n // 4 : n // 2]  # collisions: several points per cell
    z = rng.uniform(-2.5, 2.5, (b, n)).astype(np.float32)
    rgb = rng.uniform(0, 255, (b, n, 3)).astype(np.float32)
    valid = rng.uniform(size=(b, n)) < 0.8
    return xy, z, rgb, valid, h, w


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("quantize_u8", [False, True])
def test_plain_splat_matches_jax(seed, quantize_u8):
    xy, z, rgb, valid, h, w = _points(seed)
    js, jo = jbev.splat_zorder_batched(
        jnp.asarray(xy), jnp.asarray(z), jnp.asarray(rgb), jnp.asarray(valid), h, w,
        quantize_u8=quantize_u8,
    )
    ts, to = splat.splat_zorder_batched(
        torch.from_numpy(xy), torch.from_numpy(z), torch.from_numpy(rgb), torch.from_numpy(valid),
        h, w, quantize_u8=quantize_u8,
    )
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert to.numpy().any()


@pytest.mark.parametrize("seed", [0, 3])
def test_plain_priority_grid_matches_pallas_interpret(seed):
    xy, z, _, valid, h, w = _points(seed, n=512)
    cell, key, ok = splat.splat_keys(
        torch.from_numpy(xy), torch.from_numpy(z), torch.from_numpy(valid), h, w
    )
    ref = np.asarray(
        splat_priority_grid_pallas(
            jnp.asarray(cell.numpy()), jnp.asarray(key.numpy()), jnp.asarray(ok.numpy()),
            h, w, interpret=True,
        )
    )
    got = splat.splat_priority_grid(cell, key, ok, h, w)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref >= 0).any() and (ref == -1).any()


def test_priority_keys_match_jax_formula():
    """key = z_bin * N + i and the in-range tests of bev.py:148-153."""
    xy, z, _, valid, h, w = _points(5)
    n = z.shape[1]
    cell, key, ok = splat.splat_keys(torch.from_numpy(xy), torch.from_numpy(z), torch.from_numpy(valid), h, w)
    zj = jnp.asarray(z)
    z_bin = np.asarray(jnp.floor((zj - jbev.ZMIN) / (jbev.ZMAX - jbev.ZMIN) * jbev.NUM_Z_SLICES).astype(jnp.int32))
    np.testing.assert_array_equal(key.numpy(), z_bin * n + np.arange(n, dtype=np.int32)[None])
    x, y = xy[..., 0], xy[..., 1]
    ok_ref = valid & (x >= 0) & (x < w) & (y >= 0) & (y < h) & (z >= jbev.ZMIN) & (z < jbev.ZMAX)
    np.testing.assert_array_equal(ok.numpy(), ok_ref)
    np.testing.assert_array_equal(cell.numpy()[ok_ref], (y * w + x)[ok_ref])


def _emulate_b1(cell, key, ok, h, w, blocks, threads):
    """csrc/splat.cu's schedule in numpy, for a launch of `blocks` blocks of
    `threads` threads. Step 1: block g writes -1 over its stripe of
    ceil(quads / blocks) 16-byte words of the flat grid, and the first
    (B*H*W) % 4 threads the cells after the last word; the grid starts as
    -7, so a cell no one writes shows, and each must be written once.
    Step 2: warp v takes windows of 128 consecutive flat points (v, v +
    warps, ...), in 4 rounds of 32 lanes; a point's image is its index // N,
    so a window may straddle images, and lanes past B*N hold nothing. In a
    round, each maximal run of lanes with equal kept (image, cell) sends one
    atomic max of the run's keys. Returns the grid and the atomics sent."""
    b, n = cell.shape
    hw, cells, total = h * w, b * h * w, b * n
    out = np.full(cells, -7, np.int64)
    writes = np.zeros(cells, np.int64)
    quads = cells // 4
    per = -(-quads // blocks)
    for g in range(blocks):
        q0, q1 = g * per, min(g * per + per, quads)
        out[4 * q0 : 4 * max(q0, q1)] = -1
        writes[4 * q0 : 4 * max(q0, q1)] += 1
    tail = np.arange(quads * 4, cells)
    assert len(tail) <= min(3, blocks * threads)
    out[tail], writes[tail] = -1, writes[tail] + 1
    assert (writes == 1).all()

    flat_cell, flat_key, flat_ok = cell.ravel().astype(np.int64), key.ravel(), ok.ravel()
    warps = blocks * threads // 32
    seen = np.zeros(total, np.int64)
    sent = []
    for v in range(warps):
        for base in range(128 * v, total, 128 * warps):
            for j in range(4):
                i = base + 32 * j + np.arange(32)
                i = i[i < total]
                if not len(i):
                    continue
                seen[i] += 1
                c = flat_cell[i]
                g = np.where(flat_ok[i] & (c >= 0) & (c < hw), (i // n) * hw + c, -1)
                start = np.r_[True, g[1:] != g[:-1]]  # lanes that open a run
                for lo, hi in zip(np.flatnonzero(start), np.r_[np.flatnonzero(start)[1:], len(g)]):
                    if g[lo] >= 0:
                        sent.append((g[lo], flat_key[i[lo:hi]].max()))
    assert (seen == 1).all()  # every point once
    if sent:
        idx, val = (np.array(x) for x in zip(*sent))
        np.maximum.at(out, idx, val)
    return out.reshape(b, hw).astype(np.int32), len(sent)


B, H, W, N = 3, 37, 53, 1001  # N % 32 != 0: rounds straddle two images; B*H*W % 4 == 3


def _b1_case(name):
    """(cell, key, ok) of B1's CPU cases: seeded clouds through splat_keys,
    every point rejected, every point in one cell, and points on each
    image's first and last cell."""
    xy, z, _, valid, h, w = _points(11, b=B, n=N, h=H, w=W)
    cell, key, ok = (t.numpy() for t in splat.splat_keys(
        torch.from_numpy(xy), torch.from_numpy(z), torch.from_numpy(valid), h, w))
    if name == "rejected":
        ok = np.zeros_like(ok)
    elif name == "one_cell":
        cell, ok = np.full_like(cell, H * W // 2), np.ones_like(ok)
    elif name == "ends":
        cell, ok = cell.copy(), ok.copy()
        cell[:, :4], cell[:, -3:] = [0, H * W - 1, 0, H * W - 1], [H * W - 1, 0, H * W - 1]
        ok[:, :4], ok[:, -3:] = True, True
    return cell, key, ok


@pytest.mark.parametrize("case", ["seeded", "rejected", "one_cell", "ends"])
@pytest.mark.parametrize("blocks,threads", [(1, 32), (3, 64), (396, 512)])
def test_kernel_schedule_model_matches_plain_and_pallas(case, blocks, threads):
    cell, key, ok = _b1_case(case)
    plain = splat.splat_priority_grid(torch.from_numpy(cell), torch.from_numpy(key), torch.from_numpy(ok), H, W)
    pallas = np.asarray(splat_priority_grid_pallas(
        jnp.asarray(cell), jnp.asarray(key), jnp.asarray(ok), H, W, interpret=True))
    np.testing.assert_array_equal(plain.numpy(), pallas)
    got, sent = _emulate_b1(cell, key, ok, H, W, blocks, threads)
    np.testing.assert_array_equal(got, pallas)
    assert sent <= int(ok.sum())
    if case == "rejected":
        assert (pallas == -1).all() and sent == 0
    if case == "one_cell":  # one atomic a round of 32 lanes, two where an image ends inside it
        rounds = -(-B * N // 32)
        splits = sum((k * N) % 32 != 0 for k in range(1, B))
        assert (pallas >= 0).sum() == B and sent == rounds + splits
