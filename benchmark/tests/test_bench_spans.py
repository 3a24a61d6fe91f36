"""The per-layer metrics that read the program's own spans and counters: a
traced CPU run of each driver at the tiny sizes of test_bench_runs.py
reports them, with the cell's other per-layer metrics as far as they read
on the CPU, and a program that keeps no record of spans reads None."""

import time

import pytest

from benchmark import harness
from test_bench_runs import FLOORS, INFER, SEED, STEPS, TRAIN, few_threads  # noqa: F401 (autouse)

SPAN_METRICS = {
    "infer-small-floors": {"verifier_host_ms_per_batch", "upload_ms_per_pano", "batch_prep_ms_per_batch",
                           "padded_row_pct"},
    "train-device-corpus": {"train_dispatch_ms_per_step", "optimizer_host_ms_per_step"},
}
# The cells' other per-layer metrics are shares of the card's time, rooflines
# and MFU against the card's peaks, and kernel times: none reads on the CPU.
READ_ON_THE_CPU = set().union(*SPAN_METRICS.values())
TINY = {"infer-small-floors": (INFER, FLOORS), "train-device-corpus": (TRAIN, STEPS)}


@pytest.fixture(scope="module")
def traced():
    """Each cell's traced run at the tiny size, with the cell's per-layer metrics."""
    out = {}
    for cell, (config, mix) in TINY.items():
        spec = dict(harness.load_cell(cell), config=config, mix=mix)
        out[cell] = harness.run_cell(spec, SEED, 1.0, True, "cpu", time.perf_counter())
    return out


@pytest.mark.parametrize("cell", sorted(TINY))
def test_a_traced_run_reports_the_span_metrics_and_every_metric_that_reads_on_the_cpu(traced, cell):
    spec = harness.load_cell(cell)
    names = {m["name"] for m in spec["per_layer"]}
    assert SPAN_METRICS[cell] <= names
    out = traced[cell]
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == names & READ_ON_THE_CPU
    assert all(m["value"] > 0 or m["unit"] == "%" for m in out["metrics"].values()), out["metrics"]


def test_the_readings_follow_the_tiny_traffic(traced):
    from benchmark import traffic

    scoring = traced["infer-small-floors"]["metrics"]
    # The traced pass scores the mix's first `trace_floors` floors, each
    # padded up to whole batches.
    sizes = [f.n_hypotheses for f in traffic.floors(FLOORS, SEED)[:FLOORS["trace_floors"]]]
    b = INFER["batch_size"]
    rows = sum(-(-n // b) * b for n in sizes)
    assert scoring["padded_row_pct"]["value"] == pytest.approx(100.0 * (rows - sum(sizes)) / rows)
    training = traced["train-device-corpus"]["metrics"]
    assert training["optimizer_host_ms_per_step"]["value"] < training["train_dispatch_ms_per_step"]["value"]


@pytest.mark.parametrize("metric", sorted(READ_ON_THE_CPU))
def test_a_program_without_spans_or_another_driver_reads_none(monkeypatch, metric):
    from salve_tpu_torch.utils import profiler

    read = harness.reader(metric)
    driver = "fused_scoring" if metric in SPAN_METRICS["infer-small-floors"] else "verifier_training"
    other = "verifier_training" if driver == "fused_scoring" else "fused_scoring"
    monkeypatch.setattr(profiler, "span_record", lambda: [])
    assert read({"driver": driver}) is None
    monkeypatch.delattr(profiler, "span_record")
    assert read({"driver": driver}) is None
    monkeypatch.setattr(profiler, "span_record", lambda: [
        {"name": n, "start_ns": 0, "end_ns": 10**6, "counts": {"panos": 1, "rows": 8, "padded_rows": 1}}
        for n in ("salve/batch", "salve/verifier", "salve/upload", "salve/prepare", "salve/step",
                  "salve/optimizer")], raising=False)
    assert read({"driver": other}) is None
    assert read({"driver": driver}) is not None
