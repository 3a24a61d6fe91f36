"""Plain fill + mask (kernel B2's plain version) and the BEV render against
salve_tpu.

With the add order of pallas_fill.py:_box_sum the plain version matches both
the Pallas kernel (interpret mode) and the XLA conv path bit for bit. A
pure-torch model of the CUDA kernel's schedule (csrc/fill.cu: strips, row
segments, shrinking rings, select and integer den) is held to both as well.
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


# csrc/fill.cu: a warp's strip of stage columns, the six-round halo, the
# shortest row segment and the launcher's segment rule.
STAGE_W, HALO, MASK_R, MIN_SEG = 64, fill.FILL_ITERS, fill.DEFAULT_MASK_KERNEL // 2, 16
OUT_W = STAGE_W - 2 * HALO


def _segment_rows(b, h, w, resident_warps):
    """Rows of a segment, as salve_fill_mask picks them."""
    n_strip = -(-w // OUT_W)
    n_seg = max(1, resident_warps // (b * n_strip))
    n_seg = min(n_seg, -(-h // MIN_SEG))
    return -(-h // n_seg)


def _emulate_b2(sp, occ, sup, seg):
    """The kernel's schedule in torch: each (image, segment, strip) window of
    (seg + 12) x 64 stage cells runs round r only on the ring still valid
    (rows and columns [r, end - r)); every cell outside that ring holds NaN
    colour and occupancy 1, so a read outside the schedule shows. Occupancy
    is a 0/1 int with an integer den, the product a select."""
    b, h, w, _ = sp.shape
    out = torch.full_like(sp, float("nan"))
    for img in range(b):
        for y0 in range(0, h, seg):
            y1 = min(y0 + seg, h)
            rows = torch.arange(y0 - HALO, y1 + HALO)
            for xs in range(-HALO, w - HALO, OUT_W):
                cols = torch.arange(xs, xs + STAGE_W)
                inimg = ((rows >= 0) & (rows < h))[:, None] & ((cols >= 0) & (cols < w))[None, :]
                ry, cx = rows.clamp(0, h - 1)[:, None], cols.clamp(0, w - 1)[None, :]
                c = sp[img][ry, cx]  # (H, 64, 3)
                o = (occ[img][ry, cx] & inimg).int()
                sb = (sup[img][ry, cx] & inimg).int()
                hh = len(rows)
                for r in range(1, HALO + 1):
                    p = torch.where(o[..., None] > 0, c, torch.zeros_like(c))
                    vert = (p[r:hh - r] + p[r - 1:hh - r - 1]) + p[r + 1:hh - r + 1]
                    vo = o[r:hh - r] + o[r - 1:hh - r - 1] + o[r + 1:hh - r + 1]
                    cw = STAGE_W - r
                    num = (vert[:, r:cw] + vert[:, r - 1:cw - 1]) + vert[:, r + 1:cw + 1]
                    den = vo[:, r:cw] + vo[:, r - 1:cw - 1] + vo[:, r + 1:cw + 1]
                    keep = o[r:hh - r, r:cw] > 0
                    q = torch.where((den > 1)[..., None], num / den[..., None].float(), num)
                    new_c = torch.where(keep[..., None], c[r:hh - r, r:cw], q)
                    new_o = (keep | ((den > 0) & inimg[r:hh - r, r:cw])).int()
                    c = torch.full_like(c, float("nan"))
                    o = torch.ones_like(o)
                    c[r:hh - r, r:cw], o[r:hh - r, r:cw] = new_c, new_o
                # The support OR: rows first (a column's 11-bit window), then columns.
                colany = torch.stack([sb[y - MASK_R:y + MASK_R + 1].amax(0) for y in range(HALO, hh - HALO)])
                m = torch.stack([colany[:, x - MASK_R:x + MASK_R + 1].amax(1)
                                 for x in range(HALO, STAGE_W - HALO)], 1)
                x1 = min(xs + HALO + OUT_W, w)
                res = torch.where(m[..., None] > 0, c[HALO:hh - HALO, HALO:STAGE_W - HALO], 0.0)
                out[img, y0:y1, xs + HALO:x1] = res[:, : x1 - xs - HALO]
    return out


@pytest.mark.parametrize("density", [0.0, 0.02, 1.0])
@pytest.mark.parametrize("h,w", [(37, 53), (64, 64), (1, 1)])
def test_kernel_schedule_model_matches_plain_and_pallas(h, w, density):
    sp, occ, sup = _sparse(5, b=2, h=h, w=w, density=density)
    sp_t, occ_t, sup_t = torch.from_numpy(sp), torch.from_numpy(occ), torch.from_numpy(sup)
    plain = fill.fill_and_mask_plain(sp_t, occ_t, sup_t).numpy()
    pallas = np.asarray(
        fill_and_mask_batched(jnp.asarray(sp), jnp.asarray(occ), jnp.asarray(sup), interpret=True)
    )
    np.testing.assert_array_equal(plain, pallas)
    # One segment a strip, the segments of a full H100, and the shortest ones.
    segs = {h, _segment_rows(2, h, w, 132 * 6 * 2), min(h, MIN_SEG)}
    for seg in sorted(segs):
        got = _emulate_b2(sp_t, occ_t, sup_t, seg).numpy()
        np.testing.assert_array_equal(got, plain, err_msg=f"segment of {seg} rows")
    if density == 1.0:
        assert (plain == sp).all()
    if density == 0.0:
        assert not plain.any()


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
