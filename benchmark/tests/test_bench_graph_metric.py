"""`verifier_graph_pct` on synthetic span records: the replays counted on
the scorer's `salve/verifier` spans over those spans, and None where the
record has no verifier counter, on the CPU, or from another driver."""

import pytest

from benchmark import harness

CARD = {"driver": "fused_scoring", "kind": "NVIDIA H100 80GB HBM3"}


def verifier_spans(counts):
    spans = [{"name": "salve/batch", "start_ns": 0, "end_ns": 10**6, "counts": {"rows": 32, "padded_rows": 0}}
             for _ in counts]
    spans += [{"name": "salve/verifier", "start_ns": 0, "end_ns": 10**5, "counts": c} for c in counts]
    return spans


@pytest.mark.parametrize("counts, pct", [
    ([{"verifier/graph_replays": 1}] * 4, 100.0),
    ([{"verifier/graph_replays": 1, "verifier/graph_captures": 1}] + [{"verifier/graph_replays": 1}] * 3, 100.0),
    ([{"verifier/eager": 1}] + [{"verifier/graph_replays": 1}] * 3, 75.0),
    ([{"verifier/eager": 1}] * 2, 0.0),
])
def test_the_share_of_verifier_spans_that_replayed(monkeypatch, counts, pct):
    from salve_tpu_torch.utils import profiler

    monkeypatch.setattr(profiler, "span_record", lambda: verifier_spans(counts))
    assert harness.reader("verifier_graph_pct")(CARD) == pytest.approx(pct)


def test_no_verifier_counter_the_cpu_or_another_driver_reads_none(monkeypatch):
    from salve_tpu_torch.utils import profiler

    read = harness.reader("verifier_graph_pct")
    monkeypatch.setattr(profiler, "span_record", lambda: verifier_spans([{}] * 3))
    assert read(CARD) is None
    monkeypatch.setattr(profiler, "span_record", lambda: verifier_spans([{"verifier/graph_replays": 1}] * 3))
    assert read(dict(CARD, kind="cpu")) is None
    assert read(dict(CARD, driver="verifier_training")) is None
    monkeypatch.setattr(profiler, "span_record", lambda: [])
    assert read(CARD) is None
