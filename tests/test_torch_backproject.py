"""salve_tpu_torch backprojection against salve_tpu on the same inputs.

Torch's and XLA's float32 sin/cos may differ by one ulp, so the ray grid
and clouds are compared with rtol 1e-6 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salve_tpu.geometry.pano_projection import get_uni_sphere_xyz as jax_rays
from salve_tpu.ops import backproject as jbp
from salve_tpu_torch.geometry.pano_projection import get_uni_sphere_xyz
from salve_tpu_torch.ops import backproject as tbp


@pytest.mark.parametrize("h,w", [(64, 128), (512, 1024)])
def test_ray_grid_matches_jax(h, w):
    ref = np.asarray(jax_rays(h, w, xp=jnp))
    got = get_uni_sphere_xyz(h, w).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("h", [64, 512, 513])
@pytest.mark.parametrize("z_range", [tbp.FLOOR_Z_RANGE, tbp.CEILING_Z_RANGE, (-1.0, 1.0)])
def test_surface_row_window_equal(h, z_range):
    assert tbp.surface_row_window(h, z_range, tbp.DEFAULT_CROP_RATIO) == jbp.surface_row_window(
        h, z_range, jbp.DEFAULT_CROP_RATIO
    )


@pytest.mark.parametrize("z_range", [tbp.FLOOR_Z_RANGE, tbp.CEILING_Z_RANGE])
def test_backproject_depth_matches_jax(z_range):
    rng = np.random.default_rng(0)
    b, h, w = 3, 64, 128
    depths = rng.uniform(500, 6000, (b, h, w)).astype(np.uint16)
    rgbs = rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32)
    window = tbp.surface_row_window(h, z_range, 0.1)

    fn = jax.vmap(jbp.backproject_depth, in_axes=(0, 0, None, None, None))
    jxyz, jc, jv = (np.asarray(a) for a in fn(jnp.asarray(depths), jnp.asarray(rgbs), z_range, 0.1, window))
    txyz, tc, tv = tbp.backproject_depth(
        torch.from_numpy(depths.astype(np.float32)), torch.from_numpy(rgbs), z_range, 0.1, window
    )
    np.testing.assert_allclose(txyz.numpy(), jxyz, rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_array_equal(tv.numpy(), jv)
    assert tv.numpy().any() and not tv.numpy().all()


@pytest.mark.parametrize(
    "src,dst,rtol",
    [
        ((128, 256), (64, 128), 0.0),
        ((1024, 2048), (512, 1024), 0.0),
        # Upsampling: the two frameworks' interpolation weights round
        # differently, up to ~3e-6 relative on [0, 255] values.
        ((32, 64), (96, 192), 1e-5),
    ],
)
def test_resize_pano_bilinear_matches_jax(src, dst, rtol):
    """jax.image.resize antialiases on downsampling; the port matches it."""
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, src + (3,)).astype(np.uint8)
    ref = np.asarray(jbp.resize_pano_bilinear(jnp.asarray(img), *dst))
    got = tbp.resize_pano_bilinear(torch.from_numpy(img), *dst).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=1e-4)
