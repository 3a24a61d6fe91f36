"""Plain fill + mask (kernel B2's plain version) and the BEV render against
salve_tpu.

With the add order of pallas_fill.py:_box_sum the plain version matches both
the Pallas kernel (interpret mode) and the XLA conv path bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salve_tpu.ops import backproject as jbp
from salve_tpu.ops import bev as jbev
from salve_tpu.ops.pallas_fill import fill_and_mask_batched
from salve_tpu_torch.ops import bev as tbev
from salve_tpu_torch.ops import fill


def _sparse(seed, b=2, h=61, w=77, density=0.1):
    rng = np.random.default_rng(seed)
    hit = rng.uniform(size=(b, h, w, 1)) < density
    sp = np.where(hit, rng.integers(0, 256, (b, h, w, 3)), 0).astype(np.float32)
    occ = hit[..., 0]
    sup = np.all(np.clip(np.round(sp), 0, 255).astype(np.uint8) > 0, axis=-1)
    return sp, occ, sup


@pytest.mark.parametrize("seed,density", [(0, 0.1), (1, 0.02), (2, 0.5)])
def test_plain_fill_matches_pallas_and_xla(seed, density):
    sp, occ, sup = _sparse(seed, density=density)
    got = fill.fill_and_mask(torch.from_numpy(sp), torch.from_numpy(occ), torch.from_numpy(sup)).numpy()

    pallas = np.asarray(
        fill_and_mask_batched(jnp.asarray(sp), jnp.asarray(occ), jnp.asarray(sup), interpret=True)
    )
    np.testing.assert_array_equal(got, pallas)

    sp_u8 = np.clip(np.round(sp), 0, 255).astype(np.uint8)
    xla = np.asarray(
        jnp.where(
            jbev.hallucination_mask(jnp.asarray(sp_u8))[..., None],
            jbev.fill_holes(jnp.asarray(sp), jnp.asarray(occ)),
            0.0,
        )
    )
    np.testing.assert_array_equal(got, xla)
    assert (got > 0).mean() > (sp > 0).mean()  # the fill did fill


def test_support_mask_matches_hallucination_mask():
    sp, _, sup = _sparse(4, density=0.01)
    ref = np.asarray(jbev.hallucination_mask(jnp.asarray(np.clip(np.round(sp), 0, 255).astype(np.uint8))))
    np.testing.assert_array_equal(fill.support_mask(torch.from_numpy(sup)).numpy(), ref)


def test_convex_hull_mask_matches_jax():
    rng = np.random.default_rng(3)
    occ = np.zeros((3, 41, 53), bool)
    for b in range(3):
        pts = rng.integers(5, 35, (12, 2))
        occ[b, pts[:, 0], pts[:, 1]] = True
    ref = np.asarray(jbev.convex_hull_mask(jnp.asarray(occ)))
    got = tbev.convex_hull_mask(torch.from_numpy(occ)).numpy()
    assert (got != ref).mean() <= 1e-3
    assert got.sum() > occ.sum()


@pytest.mark.parametrize("z_range", [jbp.FLOOR_Z_RANGE, jbp.CEILING_Z_RANGE])
def test_render_bev_images_matches_jax(z_range):
    """Same backprojected cloud into both renders: u8 pixels agree.

    The hull's cos/sin and divisions may differ by an ulp between torch and
    XLA, which can move a pixel across its 1e-3 tolerance, so the
    renders are held to >= 99.9% equal pixels and a max difference of 1.
    """
    rng = np.random.default_rng(0)
    b, h, w = 2, 64, 128
    depths = rng.uniform(1000, 4000, (b, h, w)).astype(np.uint16)
    rgbs = (rng.integers(0, 256, (b, h, w, 3)) / 255.0).astype(np.float32)
    window = jbp.surface_row_window(h, z_range, 0.1)
    fn = jax.vmap(jbp.backproject_depth, in_axes=(0, 0, None, None, None))
    xyz, c, v = (np.array(a) for a in fn(jnp.asarray(depths), jnp.asarray(rgbs), z_range, 0.1, window))

    ref = np.asarray(jbev.render_bev_images_batched(
        jnp.asarray(xyz), jnp.asarray(c), jnp.asarray(v), img_px=100, meters_per_px=0.1
    ))
    got = tbev.render_bev_images_batched(
        torch.from_numpy(xyz), torch.from_numpy(c), torch.from_numpy(v), img_px=100, meters_per_px=0.1
    ).numpy()
    assert got.dtype == np.uint8 and got.shape == ref.shape == (b, 101, 101, 3)
    assert (got == ref).mean() >= 0.999
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    assert (ref > 0).mean() > 0.05
