"""Plain z-order splat (kernel B1's plain version) against salve_tpu.

The splat is integer work once the pixel coordinates are fixed, so given the
same integer `xy_img` and `z` the priority grid, the sparse colours and the
occupancy must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salve_tpu.ops import bev as jbev
from salve_tpu.ops.pallas_splat import splat_priority_grid_pallas
from salve_tpu_torch.ops import splat


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
