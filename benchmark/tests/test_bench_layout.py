"""The `layout_scoring` driver at a tiny size on the CPU, its plain references,
its planted faults and control, the layout stage's readers, and the work
counts of layout_work.py.

The tiny run is test_bench_runs.py's (a ResNet-50 verifier at 56 px, 101^2
renders of 64x128 panos at 0.04 m/px, batch 8) with six images and the
seed's layouts, whose W/D/O lines are 4 px wide at that scale. Its readings
set the limits here, as the configuration's are set from the card's at full
size: layout_gap read 0 sound and logit_gap 0.013-0.02; the reference's
vertices at bfloat16 read layout_gap near 0.01, and each planted fault
(pano 1's layout left unmoved, the lines a pixel thinner, windows and doors
in each other's colours) reads far above the limit.
"""

import time

import numpy as np
import pytest

from benchmark import harness, layout_work, layouts
from benchmark.drivers import layout_scoring
from benchmark.reference import layout as ref_layout
from test_bench_runs import FLOORS, INFER, SEED, few_threads  # noqa: F401 (autouse)

LAYOUT = dict(INFER, n_images=6, modalities=INFER["modalities"] + ["layout"], layout_line_px=4,
              limits={"logit_gap": 0.06, "layout_gap": 1e-4})
LAYOUT_FLOORS = dict(FLOORS, driver="layout_scoring")
METRICS = ("layout_ms_per_batch", "layout_host_ms_per_batch", "layout_roofline_pct", "device_idle_pct.layout")


def run(trace=False):
    spec = {"config": LAYOUT, "mix": LAYOUT_FLOORS, "per_layer": harness.load_cell("infer-layout-floors")["per_layer"],
            "end_to_end": [{"name": "hyp_per_s", "unit": "x"}, {"name": "setup_s", "unit": "s"}]}
    return harness.run_cell(spec, SEED, 1.0, trace, "cpu", time.perf_counter())


def test_layout_floors_agree_with_the_references():
    out = run()
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"layout_gap", "logit_gap"}
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"hyp_per_s", "setup_s"}


def test_a_traced_run_reads_the_layout_span_and_counts_each_raster_call():
    out = run(trace=True)
    assert out["correct"], out["checks"]
    # On the CPU the trace has no kernels and the card no peak: only the
    # program's span reads.
    assert set(out["metrics"]) == {"layout_host_ms_per_batch"}
    assert out["metrics"]["layout_host_ms_per_batch"]["value"] > 0
    ctx = out["res"]["ctx"]
    from benchmark import traffic

    floors = traffic.floors(LAYOUT_FLOORS, SEED)[:LAYOUT_FLOORS["trace_floors"]]
    b = LAYOUT["batch_size"]
    # A call a floor (pano 2's bank) and one a batch (pano 1's padded rows).
    assert [r["rasters"] for r in ctx["launches"]["layout"]] == [
        n for f in floors for n in [f.n_panos] + [b] * -(-f.n_hypotheses // b)]
    assert ctx["batches"] == sum(-(-f.n_hypotheses // b) for f in floors)


def test_the_references_vertices_at_bfloat16_are_not_correct():
    checks = layout_scoring.control(LAYOUT, LAYOUT_FLOORS, SEED, "cpu", n_floors=2, precision="bf16")
    assert checks["layout_gap"] > LAYOUT["limits"]["layout_gap"], checks


def _unmoved(monkeypatch):
    from salve_tpu_torch.pipeline import fused_inference

    padded = fused_inference.FloorLayouts.padded
    monkeypatch.setattr(fused_inference.FloorLayouts, "padded", lambda self, rows, moves=None: padded(self, rows))


def _thinner(monkeypatch):
    from salve_tpu_torch.rendering import layout

    width = layout.get_line_width_by_resolution
    monkeypatch.setattr(layout, "get_line_width_by_resolution", lambda r: width(r) - 1)


def _swapped(monkeypatch):
    from salve_tpu_torch.rendering import layout

    colors = dict(layout.WDO_COLORS)
    monkeypatch.setitem(layout.WDO_COLORS, "windows", colors["doors"])
    monkeypatch.setitem(layout.WDO_COLORS, "doors", colors["windows"])


@pytest.mark.parametrize("fault", [_unmoved, _thinner, _swapped], ids=["unmoved", "thinner", "swapped"])
def test_each_planted_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = run()
    assert not out["correct"]
    assert out["checks"]["layout_gap"]["value"] > 10 * LAYOUT["limits"]["layout_gap"], out["checks"]


def test_a_scorer_without_layouts_fails_at_once(monkeypatch):
    from salve_tpu_torch.pipeline import fused_inference

    def older(model, cfg, depths, rgbs, pano_id_to_bank_row, hypotheses, batch_size=32, render_cfg=None,
              use_warp_renders=None, device=None, mesh=None, depth_model=None):
        raise AssertionError("not to be called")

    monkeypatch.setattr(fused_inference, "score_floor_hypotheses", older)
    t0 = time.perf_counter()
    with pytest.raises(SystemExit, match="layouts"):
        run()
    assert time.perf_counter() - t0 < 5.0


def test_the_seeded_layouts_are_what_the_ports_parser_makes_of_the_same_draws():
    """layouts.py draws as dataset/seeded_predictions.py writes a prediction,
    and its layout is dataset/mhnet_prediction.py's reading of it."""
    from types import SimpleNamespace

    from salve_tpu_torch.dataset.mhnet_prediction import MHNetDWO, MHNetPanoStructurePrediction
    from salve_tpu_torch.dataset.mhnet_prediction import merge_wdos_straddling_img_border as merge
    from salve_tpu_torch.geometry.sim2 import Sim2

    seed = 2**31 + 77
    pool = layouts.layout_pool(12, seed)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 41]))
    graph = SimpleNamespace(nodes={0: SimpleNamespace(global_Sim2_local=Sim2.identity(), label="room")})
    for lay in pool:
        u = np.linspace(0, 2 * np.pi, 1024)
        boundary = 330 + 40 * np.sin(u * rng.integers(1, 4) + rng.uniform(0, 6)) + rng.normal(0, 2, 1024)
        feats = {}
        for kind in ("door", "window", "opening"):
            feats[kind] = []
            for _ in range(rng.integers(0, 4)):
                s = rng.uniform(0.02, 0.9)
                feats[kind].append([s, s + rng.uniform(0.02, 0.08)])
        if rng.uniform() < 0.3:
            feats["opening"] += [[0.001, 0.04], [0.96, 1.0]]
        spans = {k: merge([MHNetDWO(*x) for x in v]) for k, v in feats.items()}
        pred = MHNetPanoStructurePrediction(
            corners_in_uv=np.zeros((8, 2)), image_height=512, image_width=1024, floor_boundary=boundary,
            floor_boundary_uncertainty=np.zeros(1024), doors=spans["door"], windows=spans["window"],
            openings=spans["opening"], image_fpath="p.jpg")
        pano = pred.convert_to_pano_data(512, 1024, 0, graph, "p.jpg", 0.0)
        np.testing.assert_array_equal(lay.room, pano.room_vertices_local_2d)
        assert lay.wdos == [(w.type, w.pt1, w.pt2) for w in pano.all_wdos]
    counts = [len(x.room) for x in layouts.layout_pool(40, 3)]
    assert 500 <= min(counts) and max(counts) <= 650, counts


def test_the_reference_raster_of_a_square_room_with_a_door():
    """A 2 m square room at 0.02 m/px (1.5 x 2 m = 150 px a side, centred)
    and a door on its bottom wall: white inside, green on the door's line,
    black outside, the vertical flip putting +y at the top."""
    room = np.array([[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]])
    lay = (room, [("doors", (-0.5, -1.0), (0.5, -1.0))])
    img = ref_layout.raster(lay, 500, 0.02, 8, "cpu").numpy()
    # Image x = (1.5 p + 5) / 0.02: the room spans pixels 175-325 both ways.
    assert (img[250, 250] == 255).all() and (img[10, 10] == 0).all()
    # The door at world y = -1 is image row 175, row 500 - 175 = 325 after the flip.
    assert tuple(img[325, 250]) == (0, 255, 0) and tuple(img[75, 250]) == (0, 0, 0)
    assert tuple(img[325, 200]) == (255, 255, 255)  # the wall beside the door is the room's edge


def test_layout_work_of_a_square_room_with_one_door():
    """By hand: 501^2 x 3 bytes out, 4 vertices x 8 bytes and one door's
    endpoints and colour (16 + 12) in; 501 rows x 4 edges crossings, and the
    door's band: the segment from image x 212.5 to 287.5 on row 175 grown by
    4 + 0.65 + 0.625 = 5.275 px, pixel centres 208-292 by 170-180, 85 x 11."""
    room = np.array([[[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]]], dtype=np.float32)
    seg = np.array([[[[-0.5, -1.0], [0.5, -1.0]]]], dtype=np.float32)
    got = layout_work.work(room, np.array([4]), seg, np.array([1]), 500, 0.02, 8)
    assert got == {"bytes": 501 * 501 * 3 + 4 * 8 + 28, "ops": 501 * 4 * 4 + 85 * 11 * 32, "rasters": 1}
    # Padded slots and a segment outside the image count nothing.
    pad = np.concatenate([seg, np.full_like(seg, 100.0)], axis=1)
    assert layout_work.work(room, np.array([4]), pad, np.array([1]), 500, 0.02, 8) == got
    far = layout_work.work(room, np.array([4]), np.full_like(seg, 100.0), np.array([1]), 500, 0.02, 8)
    assert far["ops"] == 501 * 4 * 4


@pytest.mark.parametrize("metric", METRICS)
def test_the_layout_readers_read_only_the_layout_driver(monkeypatch, metric):
    from benchmark.tracing import Kernel, TraceSummary
    from salve_tpu_torch.utils import profiler

    read = harness.reader(metric)
    trace = TraceSummary(window=(0.0, 1.0), busy_s=0.5,
                         kernels=[Kernel("raster", 0.002, ("bench/layout", "bench/window")),
                                  Kernel("conv", 0.01, ("bench/verifier", "bench/window"))])
    monkeypatch.setattr(profiler, "span_record", lambda: [
        {"name": n, "start_ns": 0, "end_ns": 10**6, "counts": {}} for n in ("salve/batch", "salve/layout")])
    work = {"bytes": 3.35e12 * 1e-3, "ops": 0, "rasters": 32}
    ctx = {"driver": "layout_scoring", "kind": "NVIDIA H100 80GB HBM3", "trace": trace, "plain_window_s": 1.0,
           "launches": {"layout": [work]}, "batches": 2}
    assert read(ctx) is not None
    for driver in ("fused_scoring", "fresh_scoring", "verifier_training"):
        assert read(dict(ctx, driver=driver)) is None
    expected = {"layout_ms_per_batch": 1.0, "layout_host_ms_per_batch": 1.0, "layout_roofline_pct": 50.0,
                "device_idle_pct.layout": 50.0}
    assert read(ctx) == pytest.approx(expected[metric])
