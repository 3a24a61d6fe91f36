"""The banks' metrics. `banks_graph_pct`: a traced CPU run of each scoring
cell at the tiny sizes of test_bench_runs.py and test_bench_fresh.py
records one `salve/banks` span a floor, which counts the banks built
eagerly (the CPU has no graphs), and the reader reads such spans as it
would on the card. `b1_banks_roofline_pct` and
`b2_banks_roofline_pct`: the launches a floor's banks make, counted from
its pano count and the cell's sizes, are those the program makes, and the
share is read from the kernels found by name in the `build_banks` ranges.
On the CPU the cell's line leaves all three out, and a program without the
counters reads None."""

import time

import pytest

from benchmark import harness
from benchmark.metrics import _banks
from benchmark.rooflines import fill_bytes, fill_ops, least_seconds, splat_bytes
from benchmark.tracing import Kernel, TraceSummary
from test_bench_fresh import FRESH, FRESH_FLOORS
from test_bench_runs import FLOORS, INFER, SEED, few_threads  # noqa: F401 (autouse)

METRIC = "banks_graph_pct"
METRICS = (METRIC, "b1_banks_roofline_pct", "b2_banks_roofline_pct")
CARD = "NVIDIA H100 80GB HBM3"
# cell -> (configuration, mix)
TINY = {"infer-small-floors": (INFER, FLOORS), "infer-fresh-floors": (FRESH, FRESH_FLOORS)}


def banks_spans(counts):
    return [{"name": "salve/banks", "start_ns": 0, "end_ns": 10**6, "counts": c} for c in counts]


@pytest.fixture(scope="module", params=sorted(TINY))
def traced(request):
    """A cell's traced tiny run, with the span record it left."""
    from salve_tpu_torch.utils import profiler

    config, mix = TINY[request.param]
    spec = dict(harness.load_cell(request.param), config=config, mix=mix)
    out = harness.run_cell(spec, SEED, 1.0, True, "cpu", time.perf_counter())
    return request.param, mix["driver"], out, profiler.span_record()


def test_each_cpu_floor_counts_its_banks_eager_and_the_line_leaves_the_metric_out(traced, monkeypatch):
    from salve_tpu_torch.utils import profiler

    cell, driver, out, record = traced
    assert set(METRICS) <= {m["name"] for m in harness.load_cell(cell)["per_layer"]}
    assert out["correct"], out["checks"]
    assert not set(METRICS) & set(out["metrics"])
    banks = [s for s in record if s["name"] == "salve/banks"]
    assert len(banks) == FLOORS["trace_floors"]
    assert [s["counts"] for s in banks] == [{"banks/eager": 1}] * len(banks)
    # Read as the card's record would be, the eager floors read 0%.
    monkeypatch.setattr(profiler, "span_record", lambda: record)
    assert harness.reader(METRIC)({"driver": driver, "kind": CARD}) == 0.0


@pytest.mark.parametrize("driver", ["fused_scoring", "fresh_scoring"])
@pytest.mark.parametrize("counts, pct", [
    ([{"banks/graph_replays": 1}] * 4, 100.0),
    ([{"banks/graph_replays": 1, "banks/graph_captures": 1}] + [{"banks/graph_replays": 1}] * 3, 100.0),
    ([{"banks/eager": 1}] + [{"banks/graph_replays": 1}] * 3, 75.0),
])
def test_the_share_of_banks_spans_that_replayed(monkeypatch, driver, counts, pct):
    from salve_tpu_torch.utils import profiler

    monkeypatch.setattr(profiler, "span_record", lambda: banks_spans(counts))
    assert harness.reader(METRIC)({"driver": driver, "kind": CARD}) == pytest.approx(pct)


def test_no_banks_counter_the_cpu_or_another_driver_reads_none(monkeypatch):
    from salve_tpu_torch.utils import profiler

    read = harness.reader(METRIC)
    card = {"driver": "fused_scoring", "kind": CARD}
    monkeypatch.setattr(profiler, "span_record", lambda: banks_spans([{"launches/splat": 4}] * 3))
    assert read(card) is None
    monkeypatch.setattr(profiler, "span_record", lambda: banks_spans([{"banks/graph_replays": 1}] * 3))
    assert read(dict(card, kind="cpu")) is None
    assert read(dict(card, driver="verifier_training")) is None
    monkeypatch.setattr(profiler, "span_record", lambda: [])
    assert read(card) is None
    monkeypatch.delattr(profiler, "span_record")
    assert read(card) is None


@pytest.mark.parametrize("use_warp_renders", [True, False], ids=["warp", "direct"])
@pytest.mark.parametrize("panos, hw, img_px", [(3, (64, 128), 40), (2, (96, 64), 25)])
def test_a_floors_counted_launches_are_those_the_program_makes(monkeypatch, panos, hw, img_px, use_warp_renders):
    import numpy as np
    import torch

    from salve_tpu_torch.ops import fill, splat
    from salve_tpu_torch.pipeline import fused_inference
    from salve_tpu_torch.rendering.bev_pair import BEVRenderConfig

    made = {"b1": [], "b2": []}
    splat_plain, fill_plain = splat.splat_priority_grid_plain, fill.fill_and_mask_plain

    def b1(cell, key, ok, h, w):
        made["b1"].append((splat_bytes(cell.shape[0], cell.shape[1], h * w), 0))
        return splat_plain(cell, key, ok, h, w)

    def b2(sparse, *a):
        made["b2"].append((fill_bytes(*sparse.shape[:3]), fill_ops(*sparse.shape[:3])))
        return fill_plain(sparse, *a)

    monkeypatch.setattr(splat, "splat_priority_grid_plain", b1)
    monkeypatch.setattr(fill, "fill_and_mask_plain", b2)
    rng = np.random.default_rng(panos)
    depths = torch.from_numpy(rng.uniform(500, 4000, (panos, *hw)).astype(np.float32))
    rgbs = torch.from_numpy(rng.uniform(0, 1, (panos, *hw, 3)).astype(np.float32))
    fused_inference.build_banks(depths, rgbs, BEVRenderConfig(img_px=img_px), use_warp_renders)
    assert made == _banks.floor_launches(panos, *hw, img_px, use_warp_renders)
    assert len(made["b1"]) == len(made["b2"]) == (4 if use_warp_renders else 2)


def test_the_cells_sizes_are_found_by_the_runs_driver():
    for driver in ("fused_scoring", "fresh_scoring"):
        assert _banks.cell_sizes(driver) == (512, 1024, 500, True)
    assert _banks.cell_sizes("verifier_training") is None


def kernels(names_and_ms, ranges=("bench/build_banks", "bench/window")):
    return [Kernel(name, ms * 1e-3, ranges) for name, ms in names_and_ms]


@pytest.mark.parametrize("layer, name", [("b1", "splat_max_kernel(int const*, int const*, bool const*, int*)"),
                                         ("b2", "fill_mask_kernel(float const*, bool const*, float*, int)")])
def test_a_kernels_share_of_its_roofline_in_the_banks(layer, name):
    floors = [{"panos": 3}, {"panos": 6}]
    found = kernels([(name, 0.01 * (k + 1)) for k in range(8)]
                    + [("other_kernel", 5.0)])
    # A kernel of the name launched outside the banks is not theirs.
    found += kernels([(name, 3.0)], ranges=("bench/score_batch", "bench/window"))
    trace = TraceSummary(window=(0.0, 1.0), busy_s=0.5, kernels=found)
    ctx = {"driver": "fresh_scoring", "kind": CARD, "trace": trace, "launches": {"build_banks": floors}}
    least = sum(least_seconds(b, ops, CARD) for f in floors
                for b, ops in _banks.floor_launches(f["panos"], 512, 1024, 500, True)[layer])
    want = 100.0 * least / (sum(0.01 * (k + 1) for k in range(8)) * 1e-3)
    assert harness.reader(f"{layer}_banks_roofline_pct")(ctx) == pytest.approx(want)
    # Another number of the kernel than the floors launch, the CPU, no trace
    # or no floor read None.
    assert harness.reader(f"{layer}_banks_roofline_pct")(dict(ctx, launches={"build_banks": floors[:1]})) is None
    assert harness.reader(f"{layer}_banks_roofline_pct")(dict(ctx, kind="cpu")) is None
    assert harness.reader(f"{layer}_banks_roofline_pct")(dict(ctx, trace=None)) is None
    assert harness.reader(f"{layer}_banks_roofline_pct")(dict(ctx, launches={})) is None
