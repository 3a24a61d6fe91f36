"""The floor loop's `place_host_ms_per_floor`: a traced CPU run of each
scoring cell at the tiny sizes of test_bench_runs.py and
test_bench_fresh.py records one `salve/place` span a floor, which finds the
driver's resident models without moving them, and the reader reads those
spans as it would on the card. On the CPU the cell's line leaves the metric
out, and a program without the span reads None."""

import time

import pytest

from benchmark import harness
from test_bench_fresh import FRESH, FRESH_FLOORS
from test_bench_runs import FLOORS, INFER, SEED, few_threads  # noqa: F401 (autouse)

METRIC = "place_host_ms_per_floor"
CARD = "NVIDIA H100 80GB HBM3"
# cell -> (configuration, mix, models a floor places)
TINY = {"infer-small-floors": (INFER, FLOORS, 1), "infer-fresh-floors": (FRESH, FRESH_FLOORS, 2)}


@pytest.fixture(scope="module", params=sorted(TINY))
def traced(request):
    """A cell's traced tiny run, with the span record it left."""
    from salve_tpu_torch.utils import profiler

    config, mix, n_models = TINY[request.param]
    spec = dict(harness.load_cell(request.param), config=config, mix=mix)
    out = harness.run_cell(spec, SEED, 1.0, True, "cpu", time.perf_counter())
    return request.param, mix["driver"], n_models, out, profiler.span_record()


def test_each_floor_finds_its_models_resident_and_the_reader_reads_the_place_spans(traced, monkeypatch):
    from salve_tpu_torch.utils import profiler

    cell, driver, n_models, out, record = traced
    assert METRIC in {m["name"] for m in harness.load_cell(cell)["per_layer"]}
    assert out["correct"], out["checks"]
    assert METRIC not in out["metrics"]
    floors = [s for s in record if s["name"] == "salve/floor"]
    places = [s for s in record if s["name"] == "salve/place"]
    assert len(floors) == len(places) == FLOORS["trace_floors"]
    assert [s["counts"] for s in places] == [{"models/resident": n_models}] * len(floors)
    monkeypatch.setattr(profiler, "span_record", lambda: record)
    value = harness.reader(METRIC)({"driver": driver, "kind": CARD})
    expected = sum(s["end_ns"] - s["start_ns"] for s in places) / 1e6 / len(floors)
    assert value == pytest.approx(expected) and value > 0


@pytest.mark.parametrize("driver", ["fused_scoring", "fresh_scoring"])
def test_a_program_without_the_span_another_driver_or_the_cpu_reads_none(monkeypatch, driver):
    from salve_tpu_torch.utils import profiler

    read = harness.reader(METRIC)
    spans = [{"name": n, "start_ns": 0, "end_ns": 10**6, "counts": {}} for n in ("salve/floor", "salve/upload")]
    monkeypatch.setattr(profiler, "span_record", lambda: spans)
    assert read({"driver": driver, "kind": CARD}) is None
    spans.append({"name": "salve/place", "start_ns": 0, "end_ns": 2 * 10**5, "counts": {"models/resident": 1}})
    assert read({"driver": driver, "kind": CARD}) == pytest.approx(0.2)
    assert read({"driver": driver, "kind": "cpu"}) is None
    assert read({"driver": "verifier_training", "kind": CARD}) is None
    monkeypatch.delattr(profiler, "span_record")
    assert read({"driver": driver, "kind": CARD}) is None
