"""The `fresh_scoring` driver at a tiny size on the CPU, the HoHoNet FLOP
table, and the depth stage's readers.

The tiny run is test_bench_runs.py's (a ResNet-50 verifier at 56 px, 101^2
renders of 64x128 panos) with HoHoNet at 64x128, whose depth the scorer
computes. Its readings set the limits here, as the configuration's are set
from the card's at full size: depth_gap_mm read 0.50-0.51 sound (the
rounding to whole millimetres, and float32's last bits) and logit_gap
0.013-0.03; the control at TF32 reads depth_gap_mm 1.3-3.7 and at
bfloat16 13-40, and a pano given its neighbour's depth reads hundreds of mm.
"""

import time

import pytest
import torch

from benchmark import flops_hohonet, harness
from benchmark.drivers import fresh_scoring
from benchmark.reference import hohonet as ref_hohonet
from test_bench_runs import FLOORS, INFER, SEED, few_threads  # noqa: F401 (autouse)

FRESH = dict(INFER, depth_input_hw=[64, 128], depth_emb_dim=256, depth_heads=8, depth_ffn_dim=2048,
             depth_dct_components=64, depth_dtype="float32", limits={"logit_gap": 0.06, "depth_gap_mm": 1.0})
FRESH_FLOORS = dict(FLOORS, driver="fresh_scoring")
DEPTH_METRICS = ("depth_ms_per_pano", "depth_mfu_pct", "depth_host_ms_per_floor", "device_idle_pct.fresh")


def run(trace=False):
    spec = {"config": FRESH, "mix": FRESH_FLOORS, "per_layer": harness.load_cell("infer-fresh-floors")["per_layer"],
            "end_to_end": [{"name": "hyp_per_s", "unit": "x"}, {"name": "setup_s", "unit": "s"}]}
    return harness.run_cell(spec, SEED, 1.0, trace, "cpu", time.perf_counter())


def test_floors_scored_from_rgb_agree_with_the_references():
    out = run()
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"depth_gap_mm", "logit_gap"}
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"hyp_per_s", "setup_s"}


def test_a_traced_run_reads_the_depth_span_and_nothing_of_the_card():
    out = run(trace=True)
    assert out["correct"], out["checks"]
    # On the CPU the trace has no kernels and the card no peak: only the
    # program's span reads.
    assert set(out["metrics"]) == {"depth_host_ms_per_floor"}
    assert out["metrics"]["depth_host_ms_per_floor"]["value"] > 0
    assert out["res"]["ctx"]["launches"]["depth"]


@pytest.mark.parametrize("precision", ["tf32", "bf16"])
def test_depth_computed_in_a_lower_precision_is_not_correct(precision):
    checks = fresh_scoring.control(FRESH, FRESH_FLOORS, SEED, "cpu", n_floors=2, precision=precision)
    assert any(checks[k] > FRESH["limits"][k] for k in checks), checks


def test_a_pano_given_its_neighbours_depth_is_not_correct(monkeypatch):
    from salve_tpu_torch.pipeline import fused_inference

    depth_mm_bank = fused_inference.depth_mm_bank

    def neighbour(model, rgbs, key):
        bank = depth_mm_bank(model, rgbs, key)
        bank[0] = bank[1]
        return bank

    monkeypatch.setattr(fused_inference, "depth_mm_bank", neighbour)
    out = run()
    assert not out["correct"]
    assert out["checks"]["depth_gap_mm"]["value"] > FRESH["limits"]["depth_gap_mm"]


def test_a_scorer_without_a_depth_model_fails_at_once(monkeypatch):
    from salve_tpu_torch.pipeline import fused_inference

    def older(model, cfg, depths, rgbs, pano_id_to_bank_row, hypotheses, batch_size=32, render_cfg=None,
              use_warp_renders=None, device=None, mesh=None):
        raise AssertionError("not to be called")

    monkeypatch.setattr(fused_inference, "score_floor_hypotheses", older)
    t0 = time.perf_counter()
    with pytest.raises(SystemExit, match="depth_model"):
        run()
    assert time.perf_counter() - t0 < 5.0


def test_the_flop_table_counts_what_the_reference_computes():
    from torch.utils.flop_counter import FlopCounterMode

    for hw in ((512, 1024), (64, 128)):
        state = {k: torch.zeros(s, dtype=torch.long, device="meta") if k.endswith("num_batches_tracked")
                 else torch.empty(s, device="meta") for k, s in ref_hohonet.state_shapes(hw).items()}
        counter = FlopCounterMode(display=False)
        with counter:
            ref_hohonet.ReferenceHoHoNet(state, hw)(torch.empty(1, *hw, 3, device="meta"))
        assert counter.get_total_flops() == flops_hohonet.forward_flops(hw)
    assert flops_hohonet.forward_flops() / 1e9 == pytest.approx(105.9, abs=0.05)


@pytest.mark.parametrize("metric", DEPTH_METRICS)
def test_the_depth_readers_read_none_on_other_drivers(monkeypatch, metric):
    from benchmark.tracing import Kernel, TraceSummary
    from salve_tpu_torch.utils import profiler

    read = harness.reader(metric)
    trace = TraceSummary(window=(0.0, 1.0), busy_s=0.5,
                         kernels=[Kernel("conv", 0.01, ("bench/depth", "bench/window"))])
    monkeypatch.setattr(profiler, "span_record", lambda: [
        {"name": n, "start_ns": 0, "end_ns": 10**6, "counts": {"panos": 4}} for n in ("salve/floor", "salve/depth")])
    fresh = {"driver": "fresh_scoring", "kind": "NVIDIA H100 80GB HBM3", "trace": trace, "plain_window_s": 1.0,
             "launches": {"depth": [{"panos": 4}]}, "depth_hw": (512, 1024)}
    assert read(fresh) is not None
    for driver in ("fused_scoring", "verifier_training"):
        assert read({"driver": driver, "kind": fresh["kind"], "trace": trace, "plain_window_s": 1.0,
                     "launches": {}}) is None
    if metric == "depth_mfu_pct":
        # 105.9 GFLOP in 2.5 ms a pano, of 67 TFLOP/s.
        assert read(fresh) == pytest.approx(100 * 105.900146688e9 / 2.5e-3 / 67e12)
