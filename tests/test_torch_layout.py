"""The port's layout modality (rendering/layout.py, ops/raster.py) against
salve_tpu's on the same seeded rooms and W/D/Os.

Tolerance: none. The u8 layout images equal the reference's exactly, and
so does the float32 coverage of `polyline_coverage` against the jitted
reference. Cases include rooms of more than
64 vertices and layouts of more than 16 W/D/Os (the reference's default
padded sizes), layouts with no W/D/O, and chunk boundaries.

The tests marked `card` hold the layout kernel (csrc/layout.cu) to the plain
version byte for byte and skip without a CUDA card. The card's machine has
no JAX; there they run alone:

    python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_layout.py
"""

import numpy as np
import pytest
import torch

try:  # the CPU tests' reference; absent on the card's machine, where only the `card` tests run
    import jax.numpy as jnp
    from salve_tpu.common.wdo import WDO as JWDO
    from salve_tpu.geometry.sim2 import Sim2 as JSim2
    from salve_tpu.ops import raster as jraster
    from salve_tpu.rendering import layout as jlayout
except ImportError:
    jnp = JWDO = JSim2 = jraster = jlayout = None
from salve_tpu_torch.common.wdo import WDO
from salve_tpu_torch.geometry.sim2 import Sim2
from salve_tpu_torch.ops import raster
from salve_tpu_torch.rendering import layout
from salve_tpu_torch.utils import profiler
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

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


def _emulate_layout_kernel(verts, n_verts, segs, colors, n_wdos, img_px, mpp):
    """A model of csrc/layout.cu's schedule on the CPU, on `pack_layouts`'s
    host arrays: each live edge's crossing toggles bit ceil(x_int) (clamped
    to [0, S]) of its row's bitset, a row's inside bits are the suffix XOR
    of its 32-bit words (shifts within a word, the parity of the words
    above), and each W/D/O slot paints only the pixels of its segment's box
    grown by ceil(top) + 1 px and cut on each row to the band of that half
    width around the segment's line, in slot order. The float steps are the
    plain version's own, so any difference is the schedule's."""
    side = img_px + 1
    words = (side >> 5) + 1
    half_m = layout._half_extent_m(img_px, mpp)
    thickness = float(layout.get_line_width_by_resolution(mpp))
    reach = np.float32(np.ceil(raster.coverage_top(thickness)) + 1.0)
    rows = torch.arange(side, dtype=torch.float32)[:, None]
    out = np.zeros((len(n_verts), side, side, 3), np.uint8)
    for r in range(len(n_verts)):
        n = int(min(n_verts[r], verts.shape[1]))
        a = layout._world_to_img(torch.as_tensor(verts[r, :n]), half_m, mpp)
        c = torch.roll(a, -1, 0)
        live = ((a[:, 1] > rows) != (c[:, 1] > rows)).numpy()  # (side, n)
        dy = c[:, 1] - a[:, 1]
        den = torch.where(dy.abs() < 1e-12, torch.tensor(1e-12, dtype=torch.float32), dy)
        xi = (a[:, 0] + ((rows - a[:, 1]) * (c[:, 0] - a[:, 0])) / den).numpy()
        with np.errstate(invalid="ignore"):
            cnt = np.where(~(xi > 0), 0, np.where(xi >= side, side, np.ceil(np.minimum(xi, side)))).astype(np.int64)
        ry, re_ = np.nonzero(live & (cnt > 0))
        cnt = cnt[ry, re_]
        toggles = np.zeros((side, words), np.uint32)
        np.bitwise_xor.at(toggles, (ry, cnt >> 5), (np.uint32(1) << (cnt & 31).astype(np.uint32)))
        suffix = toggles.copy()
        for shift in (1, 2, 4, 8, 16):
            suffix ^= suffix >> np.uint32(shift)
        odd = np.unpackbits(toggles.view(np.uint8), axis=1).reshape(side, words, 32).sum(-1) & 1
        above = (np.cumsum(odd[:, ::-1], axis=1)[:, ::-1] - odd) & 1  # parity of the words past each
        inside_words = (suffix >> np.uint32(1)) ^ np.where(above == 1, np.uint32(0xFFFFFFFF), np.uint32(0))
        x = np.arange(side)
        inside = (inside_words[:, x >> 5] >> (x & 31).astype(np.uint32)) & 1
        img = torch.as_tensor(np.where(inside[..., None] == 1, 255.0, 0.0).astype(np.float32).repeat(3, -1))
        for k in range(int(min(n_wdos[r], segs.shape[1]))):
            ends = layout._world_to_img(torch.as_tensor(segs[r, k]), half_m, mpp)
            cov = raster.polyline_coverage(ends[None], torch.tensor([2]), thickness, side, side)[0]
            (ax, ay), (bx, by) = ends.numpy().astype(np.float64)
            lo = np.full(side, np.clip(np.floor(min(ax, bx) - reach), 0, side))
            hi = np.full(side, np.clip(np.ceil(max(ax, bx) + reach), -1, side - 1))
            y = np.arange(side)
            rows_in = (y >= np.clip(np.floor(min(ay, by) - reach), 0, side)) & (
                y <= np.clip(np.ceil(max(ay, by) + reach), -1, side - 1))
            if by != ay:
                xc = ax + (y - ay) * (bx - ax) / (by - ay)
                half = reach * np.hypot(bx - ax, by - ay) / abs(by - ay)
                lo = np.maximum(lo, np.clip(np.floor(xc - half), 0, side))
                hi = np.minimum(hi, np.clip(np.ceil(xc + half), -1, side - 1))
            span = torch.as_tensor(rows_in[:, None] & (x >= lo[:, None]) & (x <= hi[:, None]))
            painted = raster.paint_rgb(img, cov, torch.as_tensor(colors[r, k]))
            img = torch.where(span[..., None], painted, img)
        out[r] = torch.clamp(torch.round(img), 0, 255).to(torch.uint8).flip(0).numpy()
    return out


def _host_case(seed, n_verts, n_wdos, shift=0.0, reach=4.5, degenerate=False, seam=False):
    """Seeded padded host arrays (`pack_layouts`'s) of rooms of `n_verts`
    vertices and `n_wdos` W/D/Os a row: rooms moved by `shift` metres,
    segment ends uniform in +-`reach`; with `degenerate` each row's first
    segment a point, with `seam` its second a long span across the room (a
    seam-split opening merged into one)."""
    rng = np.random.default_rng(seed)
    b = len(n_verts)
    verts = np.zeros((b, max(max(n_verts), 1), 2), np.float32)
    segs = np.zeros((b, max(max(n_wdos), 1), 2, 2), np.float32)
    colors = np.zeros(segs.shape[:2] + (3,), np.float32)
    for r in range(b):
        if n_verts[r]:
            verts[r, :n_verts[r]] = _room(rng, n_verts[r]) + shift
        segs[r, :n_wdos[r]] = rng.uniform(-reach, reach, (n_wdos[r], 2, 2))
        colors[r, :n_wdos[r]] = COLORS[rng.integers(3, size=n_wdos[r])]
        if degenerate and n_wdos[r]:
            segs[r, 0, 1] = segs[r, 0, 0]
        if seam and n_wdos[r] > 1:
            y = rng.uniform(-1, 1)
            segs[r, 1] = [(-3.2, y), (3.1, -y)]
    return verts, np.array(n_verts), segs, colors, np.array(n_wdos)


COLORS = np.array([layout.WDO_COLORS[t] for t in TYPES], dtype=np.float32)


@pytest.mark.parametrize("seed,n_verts,n_wdos,img_px,mpp,kw", [
    (30, [580, 545], [9, 3], 500, 0.02, {}),  # the layout cell's rooms
    (31, [600, 7, 0], [0, 2, 3], 500, 0.02, {"shift": 2.5, "reach": 12.0}),  # off the image
    (32, [590, 560], [4, 6], 500, 0.02, {"degenerate": True, "seam": True}),
    (33, [1, 2, 3, 1100], [1, 0, 2, 5], 200, 0.05, {}),  # tiny rooms, and one past a vertex tile
    (34, [300], [2], 1100, 0.02, {}),  # 35 words a row: two chunks of the suffix XOR
    (35, [40, 9], [70, 65], 100, 0.1, {"reach": 6.0}),  # 2 px lines, more slots than staged
])
def test_kernel_schedule_equals_the_plain_version(seed, n_verts, n_wdos, img_px, mpp, kw):
    """The layout kernel's schedule (`_emulate_layout_kernel`) gives the
    plain version's bytes: the toggles' suffix XOR is the crossing count's
    parity, and no pixel outside a slot's box has coverage."""
    case = _host_case(seed, n_verts, n_wdos, **kw)
    inputs = layout.unpack_layouts(torch.as_tensor(layout.pack_layouts(*case)), case[0].shape[1], case[2].shape[1])
    want = layout.rasterize_layout_batch_device(*inputs, img_px, mpp).numpy()
    np.testing.assert_array_equal(_emulate_layout_kernel(*case, img_px, mpp), want)
    assert (want == 255).all(-1).any() and ((want > 0) & (want < 255)).any()


# --- on the card ----------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from salve_tpu_torch.device import resolve_device

    return resolve_device(None)


def _cell_rows(rng, b):
    """The layout cell's rooms: 537-607 vertices and 0-9 W/D/Os a row."""
    return rng.integers(537, 608, b).tolist(), rng.integers(0, 10, b).tolist()


CARD_CASES = {
    "cell batch": lambda: _host_case(0, *_cell_rows(np.random.default_rng(0), 32)),
    "B = 1": lambda: _host_case(1, [580], [3]),
    "B = 64": lambda: _host_case(2, *_cell_rows(np.random.default_rng(2), 64)),
    "no W/D/O": lambda: _host_case(3, [600] * 8, [0] * 8),
    "rooms past one tile": lambda: _host_case(4, [3000, 2500, 1025, 1024, 1023], [2, 0, 1, 3, 2]),
    "more W/D/Os than staged": lambda: _host_case(5, [50, 8, 600], [70, 65, 1]),
    "off the image": lambda: _host_case(6, [560] * 8, list(range(8)), shift=2.5, reach=30.0),
    "degenerate and seam-split": lambda: _host_case(7, [590] * 8, [1, 2, 3, 4, 5, 6, 7, 9], degenerate=True,
                                                      seam=True),
    "tiny rooms": lambda: _host_case(8, [0, 1, 2, 3, 4], [0, 1, 0, 2, 1]),
}


def _kernel_against_plain(dev, case, img_px):
    """The kernel's rasters of `case` through one packed upload's views, in
    one launch, and the plain version's on the card; copies of the views
    are refused."""
    verts, _, segs, _, _ = case
    packed = torch.as_tensor(layout.pack_layouts(*case), device=dev)
    inputs = layout.unpack_layouts(packed, verts.shape[1], segs.shape[1])
    before = profiler.counter("launches/layout")
    got = layout.rasterize_layout_batch_device(*inputs, img_px, 0.02)
    torch.cuda.synchronize()
    assert profiler.counter("launches/layout") - before == 1
    with pytest.raises(ValueError, match="views of one packed upload"):
        layout.rasterize_layout_batch_device(*[t.clone() for t in inputs], img_px, 0.02)
    return got, layout.rasterize_layout_plain(*inputs, img_px, 0.02)


@pytest.mark.card
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_layout_kernel_equals_the_plain_version(card, name):
    case = CARD_CASES[name]()
    got, want = _kernel_against_plain(card, case, 500)
    assert got.shape == want.shape == (len(case[1]), 501, 501, 3) and got.dtype == torch.uint8
    assert torch.equal(got, want)
    if name != "tiny rooms":
        assert bool((want == 255).all(-1).any())  # a room filled white
    if max(case[4]):
        assert bool(((want > 0) & (want < 255)).any())  # an anti-aliased line


@pytest.mark.card
@pytest.mark.parametrize("b", [1, 32])
def test_layout_kernel_equals_the_plain_version_at_1001(card, b):
    case = _host_case(10 + b, *_cell_rows(np.random.default_rng(10 + b), b))
    got, want = _kernel_against_plain(card, case, 1000)
    assert want.shape == (b, 1001, 1001, 3)
    assert torch.equal(got, want)


@pytest.mark.card
@pytest.mark.parametrize("img_px", [700, 800, 980])
def test_layout_kernel_equals_the_plain_version_past_the_default_shared_memory(card, img_px):
    """Sizes whose rows ask for 35-48 KB of dynamic shared memory: over the
    default cap less the kernel's static shared memory, under 48 KB."""
    case = _host_case(40 + img_px, *_cell_rows(np.random.default_rng(40 + img_px), 8))
    got, want = _kernel_against_plain(card, case, img_px)
    assert want.shape == (8, img_px + 1, img_px + 1, 3)
    assert torch.equal(got, want)


@pytest.mark.card
def test_layout_kernel_equals_the_cpu_plain_version(card):
    """The plain version on the card is no other function than on the CPU."""
    case = _host_case(20, [600, 540, 3000], [9, 0, 4], degenerate=True, seam=True)
    got, _ = _kernel_against_plain(card, case, 500)
    inputs = layout.unpack_layouts(torch.as_tensor(layout.pack_layouts(*case)), case[0].shape[1], case[2].shape[1])
    assert torch.equal(got.cpu(), layout.rasterize_layout_batch_device(*inputs, 500, 0.02))


@pytest.mark.card
def test_layout_rasters_of_host_layouts_launch_once_a_chunk(card):
    """`rasterize_layout_batch` (the corpus renderer's) launches the kernel
    once a chunk and gives the CPU's rasters."""
    lays = [(r, [WDO(Sim2.identity(), a, b, 0.0, 2.0, t) for a, b, t in w])
            for r, w in _layouts(21, [(580, 3), (600, 0), (545, 9), (5, 2), (1100, 1)])]
    before = profiler.counter("launches/layout")
    got = layout.rasterize_layout_batch(lays, chunk=2, device=card)
    assert profiler.counter("launches/layout") - before == 3
    np.testing.assert_array_equal(got, layout.rasterize_layout_batch(lays, chunk=2, device="cpu"))
