"""A floor's banks as one CUDA graph a pano count (pipeline/fused_inference.py:
`build_banks`), and the host syncs taken out of the banks' path for it: the
reciprocals of `div_const` and the ImageNet mean are constants made once a
device (ops/numerics.py:`constant`), with the products they always gave,
and `convex_hull_mask` copies no scalar to the card.

The CPU tests run everywhere: the CPU builds its banks eagerly. The tests
marked `card` skip without a CUDA card; on the card, with no JAX installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_banks_graph.py
"""

import math

import numpy as np
import pytest
import torch

from salve_tpu_torch.common.alignment_hypothesis import AlignmentHypothesis
from salve_tpu_torch.dataset.synthetic_bank import make_synthetic_pano_bank
from salve_tpu_torch.device import KERNELS
from salve_tpu_torch.geometry.sim2 import Sim2
from salve_tpu_torch.models.early_fusion import EarlyFusionCEResnet
from salve_tpu_torch.ops import bev, numerics, raster
from salve_tpu_torch.ops.splat import ZMAX, ZMIN
from salve_tpu_torch.pipeline import fused_inference
from salve_tpu_torch.rendering.bev_pair import BEVRenderConfig
from salve_tpu_torch.training import transforms
from salve_tpu_torch.training.config import TrainingConfig
from salve_tpu_torch.utils import profiler
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

COUNTERS = ("banks/graph_captures", "banks/graph_replays", "banks/eager")
LAUNCHES = tuple("launches/" + k for k in KERNELS)
SMALL = BEVRenderConfig(img_px=100, meters_per_px=0.1)

# Every constant the port divides by (`div_const`'s callers): render
# resolutions (ops/bev.py, ops/warp.py, rendering/layout.py), the z-slice
# span (ops/splat.py), pano widths and heights (geometry/pano_projection.py),
# the rot90 quarter and the half angle (ops/warp.py), the raster's ramp
# (ops/raster.py) and the ImageNet deviations (training/transforms.py).
DIVISORS = [0.02, 0.1, 0.05, ZMAX - ZMIN, 1024, 512, 128, 64, math.pi / 2, 2, raster.AA_RAMP,
            transforms.IMAGENET_STD]


def counted(fn, names=COUNTERS + LAUNCHES):
    """fn()'s result and what it added to each counter of `names`."""
    before = {n: profiler.counter(n) for n in names}
    out = fn()
    return out, {n: profiler.counter(n) - before[n] for n in names}


def convex_hull_mask_with_a_device_scalar(occupied, n_directions=64):
    """`convex_hull_mask` as it was, with its bound a float32 tensor copied
    to the mask's device: the reference for the scalar bound."""
    batch = occupied.shape[:-2]
    h, w = occupied.shape[-2:]
    dev = occupied.device
    occ = occupied.reshape(-1, h, w)
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    big = torch.tensor(1e9, dtype=torch.float32, device=dev)
    xmin = torch.where(occ, xs[None, None, :], big).amin(dim=2)
    xmax = torch.where(occ, xs[None, None, :], -big).amax(dim=2)
    row_has = occ.any(dim=2)
    theta = torch.arange(n_directions, dtype=torch.float32, device=dev) * (2.0 * math.pi / n_directions)
    cos, sin = torch.cos(theta), torch.sin(theta)
    ext_x = torch.stack([xmin, xmax], dim=-1)
    proj = ext_x[..., None] * cos + ys[None, :, None, None] * sin
    proj = torch.where(row_has[..., None, None], proj, -big)
    hsup = proj.amax(dim=(1, 2))
    t = hsup[:, None, :] - ys[None, :, None] * sin
    eps = 1e-4
    pos, neg = cos > eps, cos < -eps
    one = torch.ones_like(cos)
    xhi = torch.where(pos, t / torch.where(pos, cos, one), big).amin(dim=-1)
    xlo = torch.where(neg, t / torch.where(neg, cos, one), -big).amax(dim=-1)
    row_ok = torch.where(cos.abs() <= eps, t >= -eps, torch.ones_like(t, dtype=torch.bool)).all(dim=-1)
    tol = 1e-3
    mask = row_ok[..., None] & (xs[None, None, :] >= xlo[..., None] - tol) & (xs[None, None, :] <= xhi[..., None] + tol)
    return mask.reshape(batch + (h, w))


def floor_banks(p, seed=0, hw=(512, 1024), dev="cpu"):
    """A floor's u16 depth in mm (as float32) and RGB in [0, 1] on `dev`."""
    depths, rgbs = make_synthetic_pano_bank(p, *hw, seed=seed)
    return (torch.as_tensor(np.asarray(depths, dtype=np.float32), device=dev),
            torch.as_tensor(np.asarray(rgbs, dtype=np.float32), device=dev))


# --- on the CPU ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("c", DIVISORS, ids=lambda c: "imagenet_std" if isinstance(c, tuple) else repr(c))
def test_div_const_gives_the_product_with_the_float32_reciprocal_bit_for_bit(c, dtype):
    x = torch.from_numpy(np.random.default_rng(7).uniform(-3e3, 3e3, (257, 3))).to(dtype)
    recip = np.float32(1.0) / np.asarray(c, dtype=np.float32)
    want = x * torch.as_tensor(recip, dtype=torch.float32)
    got = numerics.div_const(x, c)
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_a_constant_is_made_once_a_value_shape_and_device():
    x = torch.rand(5, 3)
    first = numerics.constant(np.float32(1.0) / np.float32(0.03), x.device)
    made = numerics._constant.cache_info().currsize
    assert numerics.constant(np.float32(1.0) / np.float32(0.03), torch.device("cpu")) is first
    numerics.div_const(x, 0.03)
    numerics.div_const(x, 0.03)
    assert numerics._constant.cache_info().currsize == made
    # Another value, or the same values in another shape, is another constant.
    assert numerics.constant((1.0, 2.0), "cpu") is not numerics.constant((1.0, 2.0, 3.0), "cpu")
    assert numerics.constant(2.0, "cpu").shape == () and numerics.constant((2.0,), "cpu").shape == (1,)


def test_normalize_batch_is_unchanged():
    imgs = torch.from_numpy(np.random.default_rng(3).uniform(0, 255, (2, 4, 9, 9, 3)).astype(np.float32))
    mean = torch.tensor(transforms.IMAGENET_MEAN, dtype=torch.float32)
    want = (imgs - mean) * torch.as_tensor(np.float32(1.0) / np.asarray(transforms.IMAGENET_STD, dtype=np.float32))
    assert torch.equal(transforms.normalize_batch(imgs), want)


@pytest.mark.parametrize("shape", [(3, 61, 47), (2, 2, 33, 33), (1, 1, 1)])
def test_convex_hull_mask_is_unchanged(shape):
    rng = np.random.default_rng(len(shape))
    occ = torch.from_numpy(rng.uniform(size=shape) < 0.02)
    occ.view(-1, *shape[-2:])[0] = False  # one plane with nothing in it
    assert torch.equal(bev.convex_hull_mask(occ), convex_hull_mask_with_a_device_scalar(occ))


@pytest.mark.parametrize("use_warp_renders", [True, False], ids=["warp", "direct"])
def test_cpu_banks_are_built_eagerly_and_count_it_once_a_floor(use_warp_renders, tmp_path):
    depths, rgbs = floor_banks(3, hw=(64, 128))
    got, added = counted(lambda: fused_inference.build_banks(depths, rgbs, SMALL, use_warp_renders))
    assert added == {"banks/graph_captures": 0, "banks/graph_replays": 0, "banks/eager": 1,
                     **{n: 0 for n in LAUNCHES}}
    want = fused_inference._banks(depths, rgbs, SMALL, use_warp_renders)
    if not use_warp_renders:
        want = (depths, rgbs, *want)
        assert got[0] is depths and got[1] is rgbs
    assert len(got) == 4 and all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.device("cpu") not in fused_inference._BANK_GRAPHS

    # In the scorer, each floor's `banks` span holds the one count.
    torch.manual_seed(0)
    model = EarlyFusionCEResnet(num_layers=18, compute_dtype="bfloat16")
    hyps = [(0, 1 + k % 2, AlignmentHypothesis(i2Ti1=Sim2.from_theta_deg(15.0 * k, np.array([0.1, 0.2 * k])),
                                               wdo_alignment_object="door", i1_wdo_idx=k, i2_wdo_idx=0,
                                               configuration="identity")) for k in range(5)]
    cfg = TrainingConfig(num_layers=18, resize_h=64, resize_w=64, train_h=56, train_w=56,
                         modalities=("ceiling_rgb_texture", "floor_rgb_texture"), compute_dtype="bfloat16")
    with profiler.device_trace(str(tmp_path)):
        for _ in range(2):
            fused_inference.score_floor_hypotheses(
                model, cfg, depths.numpy().astype(np.uint16), rgbs.numpy(), {0: 0, 1: 1, 2: 2}, hyps,
                batch_size=4, render_cfg=SMALL, use_warp_renders=use_warp_renders, device="cpu")
    spans = [s for s in profiler.span_record() if s["name"] == "salve/banks"]
    assert [s["counts"] for s in spans] == [{"banks/eager": 1}] * 2


# --- on the card ----------------------------------------------------------------


@pytest.fixture
def card(monkeypatch):
    """The card, with no banks graph captured yet (nor a pool for them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from salve_tpu_torch.device import resolve_device

    monkeypatch.setattr(fused_inference, "_BANK_GRAPHS", {})
    return resolve_device(None)


def n_graphs():
    return sum(len(graphs) for _, graphs in fused_inference._BANK_GRAPHS.values())


def eager(depths, rgbs, cfg, use_warp_renders):
    """The banks rendered eagerly on the card, and the launches that took."""
    out, added = counted(lambda: fused_inference._banks(depths, rgbs, cfg, use_warp_renders), LAUNCHES)
    return (out if use_warp_renders else (depths, rgbs, *out)), added


@pytest.mark.card
@pytest.mark.parametrize("use_warp_renders", [True, False], ids=["warp", "direct"])
@pytest.mark.parametrize("p", [3, 4, 5, 6])
def test_graphed_banks_equal_the_eager_banks(card, p, use_warp_renders):
    cfg = BEVRenderConfig()
    depths, rgbs = floor_banks(p, seed=p, dev=card)
    want, eager_launches = eager(depths, rgbs, cfg, use_warp_renders)
    assert eager_launches == {"launches/splat": 4 if use_warp_renders else 2,
                              "launches/fill": 4 if use_warp_renders else 2, "launches/warp": 0}
    # The capturing floor launches each kernel twice, in the eager run on a
    # side stream and in the capture; a replay launches none of its own.
    for captures, launches in ((1, 2), (0, 0)):
        got, added = counted(lambda: fused_inference.build_banks(depths, rgbs, cfg, use_warp_renders))
        assert added == {"banks/graph_captures": captures, "banks/graph_replays": 1, "banks/eager": 0,
                         **{n: launches * k for n, k in eager_launches.items()}}
        assert len(got) == 4 and all(torch.equal(g, w) for g, w in zip(got, want))
        assert all(g.dtype == w.dtype and g.shape == w.shape for g, w in zip(got, want))
    assert n_graphs() == 1


@pytest.mark.card
def test_a_floor_replayed_after_another_leaves_the_first_floors_banks_as_they_were(card):
    cfg = BEVRenderConfig()
    floors = [floor_banks(p, seed=s, dev=card) for p, s in ((4, 1), (4, 2), (3, 3), (4, 4))]
    kept = []
    for depths, rgbs in floors:
        got = fused_inference.build_banks(depths, rgbs, cfg, True)
        kept.append((got, [g.clone() for g in got]))
    torch.cuda.synchronize()
    assert n_graphs() == 2 and len(fused_inference._BANK_GRAPHS) == 1  # one a pano count, in one pool
    for (depths, rgbs), (got, copies) in zip(floors, kept):
        want, _ = eager(depths, rgbs, cfg, True)
        assert all(torch.equal(g, c) for g, c in zip(got, copies))
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert not torch.equal(kept[0][0][0], kept[1][0][0])


@pytest.mark.card
def test_the_key_follows_the_shape_the_render_config_and_the_mode(card):
    depths, rgbs = floor_banks(3, dev=card)
    for cfg, warp, captures in ((SMALL, True, 1), (SMALL, True, 0), (SMALL, False, 1), (BEVRenderConfig(), True, 1),
                                (SMALL, False, 0)):
        _, added = counted(lambda: fused_inference.build_banks(depths, rgbs, cfg, warp), COUNTERS)
        assert added == {"banks/graph_captures": captures, "banks/graph_replays": 1, "banks/eager": 0}
    _, added = counted(lambda: fused_inference.build_banks(depths[:2], rgbs[:2], SMALL, True), COUNTERS)
    assert added["banks/graph_captures"] == 1 and n_graphs() == 4


@pytest.mark.card
@pytest.mark.parametrize("use_warp_renders", [True, False], ids=["warp", "direct"])
def test_a_floor_of_more_panos_builds_its_banks_eagerly(card, use_warp_renders):
    cfg = BEVRenderConfig()
    p = fused_inference.GRAPHED_MAX_PANOS + 1
    depths, rgbs = floor_banks(p, seed=p, dev=card)
    want, eager_launches = eager(depths, rgbs, cfg, use_warp_renders)
    for _ in range(2):
        got, added = counted(lambda: fused_inference.build_banks(depths, rgbs, cfg, use_warp_renders))
        assert added == {"banks/graph_captures": 0, "banks/graph_replays": 0, "banks/eager": 1, **eager_launches}
        assert len(got) == 4 and all(torch.equal(g, w) for g, w in zip(got, want))
    assert n_graphs() == 0


@pytest.mark.card
@pytest.mark.parametrize("use_warp_renders", [True, False], ids=["warp", "direct"])
def test_a_replayed_floor_makes_no_host_sync(card, use_warp_renders):
    cfg = BEVRenderConfig()
    depths, rgbs = floor_banks(5, dev=card)
    fused_inference.build_banks(depths, rgbs, cfg, use_warp_renders)  # the capture may wait for the card
    other = floor_banks(5, seed=9, dev=card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        # The mode sees the kind of copy the banks' path made before.
        with pytest.raises(RuntimeError, match="synchroniz"):
            torch.tensor(1e9, dtype=torch.float32, device=card)
        got = fused_inference.build_banks(*other, cfg, use_warp_renders)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want, _ = eager(*other, cfg, use_warp_renders)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
