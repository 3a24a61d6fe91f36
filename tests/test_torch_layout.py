"""The port's layout modality (rendering/layout.py, ops/raster.py) against
salve_tpu's on the same seeded rooms and W/D/Os.

Tolerance: none. The u8 layout images equal the reference's exactly, and
so does the float32 coverage of `polyline_coverage` against the jitted
reference. Cases include rooms of more than
64 vertices and layouts of more than 16 W/D/Os (the reference's default
padded sizes), layouts with no W/D/O, and chunk boundaries.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salve_tpu.common.wdo import WDO as JWDO
from salve_tpu.geometry.sim2 import Sim2 as JSim2
from salve_tpu.ops import raster as jraster
from salve_tpu.rendering import layout as jlayout
from salve_tpu_torch.common.wdo import WDO
from salve_tpu_torch.geometry.sim2 import Sim2
from salve_tpu_torch.ops import raster
from salve_tpu_torch.rendering import layout

TYPES = ("windows", "doors", "openings")


def _room(rng, n):
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    r = rng.uniform(1.0, 4.5, n)
    return np.stack([r * np.cos(ang), r * np.sin(ang)], -1) + rng.normal(0, 0.4, 2)


def _layouts(seed, shapes):
    """Seeded (room, [(pt1, pt2, type)]) layouts of the given (vertices, W/D/Os)."""
    rng = np.random.default_rng(seed)
    out = []
    for nv, nw in shapes:
        room = _room(rng, nv)
        wdos = [(tuple(rng.uniform(-4.5, 4.5, 2)), tuple(rng.uniform(-4.5, 4.5, 2)), TYPES[rng.integers(3)])
                for _ in range(nw)]
        out.append((room, wdos))
    return out


def _both(lays):
    ref = [(r, [JWDO(JSim2.identity(), a, b, 0.0, 2.0, t) for a, b, t in w]) for r, w in lays]
    port = [(r, [WDO(Sim2.identity(), a, b, 0.0, 2.0, t) for a, b, t in w]) for r, w in lays]
    return ref, port


def test_line_width_by_resolution():
    for res in (0.005, 0.01, 0.02, 0.05, 1.0):
        assert layout.get_line_width_by_resolution(res) == jlayout.get_line_width_by_resolution(res)


@pytest.mark.parametrize(
    "seed,shapes,chunk",
    [
        (0, [(4, 2), (7, 0), (12, 5)], 64),
        (1, [(70, 3), (5, 18), (90, 20)], 2),  # > 64 vertices, > 16 W/D/Os, chunk edges
        (2, [(3, 1), (6, 16), (64, 4), (65, 17), (8, 8)], 3),
    ],
)
def test_layout_batch_equals_reference(seed, shapes, chunk):
    ref, port = _both(_layouts(seed, shapes))
    want = jlayout.rasterize_layout_batch(ref, chunk=chunk)
    got = layout.rasterize_layout_batch(port, chunk=chunk, device="cpu")
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert (got == 255).any() and (got[..., 0] != got[..., 1]).any()  # room fill and coloured lines


def test_on_chunk_streams_and_single_layout_equal_reference():
    ref, port = _both(_layouts(3, [(5, 3), (9, 2), (6, 4)]))
    chunks = []
    assert layout.rasterize_layout_batch(port, chunk=2, device="cpu", on_chunk=lambda s, a: chunks.append((s, a))) is None
    assert [s for s, _ in chunks] == [0, 2] and [a.shape[0] for _, a in chunks] == [2, 1]
    np.testing.assert_array_equal(np.concatenate([a for _, a in chunks]), jlayout.rasterize_layout_batch(ref))
    np.testing.assert_array_equal(layout.rasterize_single_layout(*port[1], device="cpu"),
                                  jlayout.rasterize_single_layout(*ref[1]))
    empty = layout.rasterize_layout_batch([], device="cpu")
    assert empty.shape == (0, 501, 501, 3)


def test_pair_inputs_move_pano_1_as_the_reference():
    from salve_tpu.common.pano_data import PanoData as JPano
    from salve_tpu_torch.common.pano_data import PanoData

    rng = np.random.default_rng(4)
    room = _room(rng, 6)

    def pano(cls, wdo_cls, sim_cls, pid):
        w = lambda a, b, t: wdo_cls(sim_cls.identity(), a, b, 0.0, 2.0, t)
        return cls(id=pid, global_Sim2_local=sim_cls.identity(), room_vertices_local_2d=room, image_path=f"p_{pid}.jpg",
                   label="room", doors=[w((1.0, 0.5), (1.0, -0.5), "doors")], windows=[w((-1.0, 1.0), (0.0, 1.2), "windows")],
                   openings=[])

    S, JS = Sim2.from_theta_deg(33.0, np.array([0.4, -1.1])), JSim2.from_theta_deg(33.0, np.array([0.4, -1.1]))
    got = layout.layout_pair_inputs(S, pano(PanoData, WDO, Sim2, 1), pano(PanoData, WDO, Sim2, 2))
    want = jlayout.layout_pair_inputs(JS, pano(JPano, JWDO, JSim2, 1), pano(JPano, JWDO, JSim2, 2))
    for (gv, gw), (wv, ww) in zip(got, want):
        np.testing.assert_array_equal(gv, wv)
        assert [(w.pt1, w.pt2, w.type) for w in gw] == [(w.pt1, w.pt2, w.type) for w in ww]
    imgs = layout.rasterize_layout_batch(list(got), device="cpu")
    np.testing.assert_array_equal(imgs, jlayout.rasterize_layout_batch(list(want)))


@pytest.mark.parametrize("seed", range(4))
def test_polyline_coverage_equals_jitted_reference(seed):
    """Segments anywhere on the grid, also a degenerate one (a point): the
    float32 coverage, not only the rounded u8, is the reference's. (The
    paint is held through the layout images above: XLA:CPU fuses its
    multiply-adds by context, and the port follows the layout's.)"""
    rng = np.random.default_rng(seed)
    seg = rng.uniform(-20, 520, (2, 2)).astype(np.float32)
    if seed == 3:
        seg[1] = seg[0]
    want = np.asarray(jraster.polyline_coverage(jnp.asarray(seg), jnp.int32(2), jnp.float32(8.0), 501, 501))
    got = raster.polyline_coverage(torch.from_numpy(seg)[None], torch.tensor([2]), 8.0, 501, 501)[0].numpy()
    np.testing.assert_array_equal(got, want)
    assert ((got > 0) & (got < 1)).any()
