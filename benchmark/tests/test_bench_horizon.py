"""The `horizon_scoring` driver at a tiny size on the CPU, its plain
references, controls and planted faults, the horizon stage's readers, and
the HorizonNet FLOP table.

The tiny run is test_bench_layout.py's (a ResNet-50 six-image verifier at
56 px, 101^2 renders of 64x128 panos, batch 8) at 0.1 m/px with 2 px W/D/O
lines, rendering.layout's width there (a 64-row pano's rooms reach past
the 0.04 m/px raster), with HorizonNet at 64x128 computing each pano's
boundary. Its readings set the limits here, as the configuration's are set
from the card's at full size: boundary_gap_px read 1e-5-2e-5 rows sound
(float32's last bits over a boundary spread 5 rows about row 40 of 64),
layout_gap 0 and logit_gap 0.01-0.03; the reference's boundaries at TF32
read some 1e-2 rows and at bfloat16 9e-2, a boundary shifted by a column
and each planted fault of the reference 0.6 rows or more; spans left out
read layout_gap far above its limit.
"""

import time

import numpy as np
import pytest
import torch

from benchmark import flops_horizonnet, harness
from benchmark.drivers import horizon_scoring
from benchmark.reference import horizonnet as ref_horizon
from test_bench_layout import LAYOUT
from test_bench_runs import FLOORS, SEED, few_threads  # noqa: F401 (autouse)

HORIZON = dict(LAYOUT, meters_per_px=0.1, layout_line_px=2, horizonnet_backbone="resnet50", horizonnet_rnn_layers=2,
               horizonnet_rnn_hidden=512, horizonnet_bidirectional=True, horizonnet_step_cols=4, horizonnet_out_scale=8,
               horizonnet_input_hw=[64, 128], horizonnet_dtype="float32",
               limits={"boundary_gap_px": 1e-3, "layout_gap": 1e-4, "logit_gap": 0.06})
HORIZON_FLOORS = dict(FLOORS, driver="horizon_scoring")
METRICS = ("horizon_ms_per_pano", "horizon_mfu_pct", "horizon_host_ms_per_floor", "boundary_host_ms_per_floor",
           "device_idle_pct.horizon")


def run(trace=False):
    spec = {"config": HORIZON, "mix": HORIZON_FLOORS,
            "per_layer": harness.load_cell("infer-horizon-floors")["per_layer"],
            "end_to_end": [{"name": "hyp_per_s", "unit": "x"}, {"name": "setup_s", "unit": "s"}]}
    return harness.run_cell(spec, SEED, 1.0, trace, "cpu", time.perf_counter())


def test_horizon_floors_agree_with_the_references():
    out = run()
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"boundary_gap_px", "layout_gap", "logit_gap"}
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"hyp_per_s", "setup_s"}


def test_a_traced_run_reads_the_horizon_and_boundary_spans():
    out = run(trace=True)
    assert out["correct"], out["checks"]
    # On the CPU the trace has no kernels and the card no peak: only the
    # program's spans read.
    assert set(out["metrics"]) == {"horizon_host_ms_per_floor", "boundary_host_ms_per_floor"}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    from benchmark import traffic

    floors = traffic.floors(HORIZON_FLOORS, SEED)[:HORIZON_FLOORS["trace_floors"]]
    assert [r["panos"] for r in out["res"]["ctx"]["launches"]["horizon"]] == [f.n_panos for f in floors]


@pytest.mark.parametrize("precision", ["tf32", "bf16"])
def test_boundaries_in_a_lower_precision_are_not_correct(precision):
    checks = horizon_scoring.control(HORIZON, HORIZON_FLOORS, SEED, "cpu", n_floors=2, precision=precision)
    assert checks["boundary_gap_px"] > HORIZON["limits"]["boundary_gap_px"], checks


@pytest.mark.parametrize("fault", ref_horizon.FAULTS)
def test_each_planted_fault_of_the_reference_is_not_correct(fault):
    checks = horizon_scoring.control(HORIZON, HORIZON_FLOORS, SEED, "cpu", n_floors=2, fault=fault)
    assert checks["boundary_gap_px"] > 100 * HORIZON["limits"]["boundary_gap_px"], checks


def test_a_sound_control_is_correct():
    checks = horizon_scoring.control(HORIZON, HORIZON_FLOORS, SEED, "cpu", n_floors=2)
    assert all(checks[k] <= HORIZON["limits"][k] for k in checks), checks


def _shifted(monkeypatch):
    from salve_tpu_torch.pipeline import fused_inference

    real = fused_inference.floor_boundary_bank
    monkeypatch.setattr(fused_inference, "floor_boundary_bank", lambda *a, **k: torch.roll(real(*a, **k), 1, 1))


def _spans_ignored(monkeypatch):
    from salve_tpu_torch.pipeline import fused_inference

    real = fused_inference.boundary_layouts
    monkeypatch.setattr(fused_inference, "boundary_layouts", lambda boundary, spans: real(
        boundary, [{t: [] for t in ("doors", "windows", "openings")} for _ in spans]))


@pytest.mark.parametrize("fault,check", [(_shifted, "boundary_gap_px"), (_spans_ignored, "layout_gap")],
                         ids=["shifted", "spans_ignored"])
def test_each_planted_fault_of_the_program_is_not_correct(monkeypatch, fault, check):
    fault(monkeypatch)
    out = run()
    assert not out["correct"]
    assert out["checks"][check]["value"] > 10 * HORIZON["limits"][check], out["checks"]


def test_a_scorer_without_a_layout_model_fails_at_once(monkeypatch):
    from salve_tpu_torch.pipeline import fused_inference

    def older(model, cfg, depths, rgbs, pano_id_to_bank_row, hypotheses, batch_size=32, render_cfg=None,
              use_warp_renders=None, device=None, mesh=None, depth_model=None, layouts=None):
        raise AssertionError("not to be called")

    monkeypatch.setattr(fused_inference, "score_floor_hypotheses", older)
    t0 = time.perf_counter()
    with pytest.raises(SystemExit, match="layout_model"):
        run()
    assert time.perf_counter() - t0 < 5.0


def test_the_spans_follow_the_seeded_law_and_the_reference_parser_is_the_ports():
    """span_pool draws layouts.py's law of W/D/Os; reference_layout is the
    port's parser's reading of a boundary and its spans, at 512x1024."""
    from types import SimpleNamespace

    from salve_tpu_torch.dataset.mhnet_prediction import MHNetDWO, MHNetPanoStructurePrediction
    from salve_tpu_torch.geometry.sim2 import Sim2

    pool = horizon_scoring.span_pool(40, 3)
    counts = [len(s[t]) for s in pool for t in ("doors", "windows")]
    assert min(counts) == 0 and max(counts) == 3
    merged = [s for p in pool for s in p["openings"] if s[0] > s[1]]
    assert 4 <= len(merged) <= 24  # 30% of 40 panos, each merged last
    graph = SimpleNamespace(nodes={0: SimpleNamespace(global_Sim2_local=Sim2.identity(), label="room")})
    rng = np.random.default_rng(5)
    for spans in pool[:6]:
        rows = (330 + 40 * np.sin(np.linspace(0, 6, 1024)) + rng.normal(0, 2, 1024)).astype(np.float32)
        lay = horizon_scoring.reference_layout(rows, spans, (512, 1024))
        pred = MHNetPanoStructurePrediction(
            corners_in_uv=np.zeros((8, 2)), image_height=512, image_width=1024, floor_boundary=rows,
            floor_boundary_uncertainty=np.zeros(1024), image_fpath="p.jpg",
            **{t: [MHNetDWO(s, e) for s, e in spans[t]] for t in ("doors", "windows", "openings")})
        pano = pred.convert_to_pano_data(512, 1024, 0, graph, "p.jpg", 0.0)
        np.testing.assert_allclose(lay.room, pano.room_vertices_local_2d, rtol=0, atol=1e-9)
        assert [w[0] for w in lay.wdos] == [w.type for w in pano.all_wdos]
        np.testing.assert_allclose([w[1] + w[2] for w in lay.wdos], [w.pt1 + w.pt2 for w in pano.all_wdos],
                                   rtol=0, atol=1e-9)


@pytest.mark.parametrize("hw", [(64, 128), (128, 256)])
def test_the_flop_table_matches_a_layer_by_layer_count_of_the_ports_model(hw):
    from salve_tpu_torch.models.horizonnet import HorizonNet

    model = HorizonNet(hw).eval()
    macs = {"conv": 0, "linear": 0}

    def conv_hook(m, _, out):
        macs["conv"] += out.numel() * m.in_channels * m.kernel_size[0] * m.kernel_size[1] // m.groups

    def linear_hook(m, _, out):
        macs["linear"] += out.numel() * m.in_features

    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(conv_hook)
        elif isinstance(m, torch.nn.Linear):
            m.register_forward_hook(linear_hook)
    with torch.no_grad():
        model(torch.rand(1, 3, *hw))
    steps = hw[1] // 4
    lstm = sum(steps * p.shape[0] * p.shape[1] for n, p in model.bi_rnn.named_parameters() if n.startswith("weight"))
    parts = flops_horizonnet.forward_macs_by_part(hw)
    assert parts["trunk"] + parts["height_compression"] == macs["conv"]
    assert parts["lstm"] == lstm + macs["linear"]
    assert flops_horizonnet.forward_flops(hw) == 2.0 * (macs["conv"] + lstm + macs["linear"])


def test_the_flop_table_at_the_published_size():
    parts = {k: 2 * v / 1e9 for k, v in flops_horizonnet.forward_macs_by_part().items()}
    assert parts["trunk"] == pytest.approx(85.41, abs=0.01)
    assert parts["height_compression"] == pytest.approx(51.04, abs=0.01)
    assert parts["lstm"] == pytest.approx(6.45, abs=0.01)
    assert flops_horizonnet.forward_flops() / 1e9 == pytest.approx(142.9, abs=0.05)


@pytest.mark.parametrize("metric", METRICS)
def test_the_horizon_readers_read_only_the_horizon_driver(monkeypatch, metric):
    from benchmark.tracing import Kernel, TraceSummary
    from salve_tpu_torch.utils import profiler

    read = harness.reader(metric)
    trace = TraceSummary(window=(0.0, 1.0), busy_s=0.5,
                         kernels=[Kernel("conv", 0.02, ("bench/horizon", "bench/window")),
                                  Kernel("gemm", 0.01, ("bench/verifier", "bench/window"))])
    monkeypatch.setattr(profiler, "span_record", lambda: [
        {"name": n, "start_ns": 0, "end_ns": 10**6, "counts": {}}
        for n in ("salve/floor", "salve/horizon", "salve/boundary")])
    ctx = {"driver": "horizon_scoring", "kind": "NVIDIA H100 80GB HBM3", "trace": trace, "plain_window_s": 1.0,
           "launches": {"horizon": [{"panos": 4}]}, "horizon_hw": [512, 1024]}
    assert read(ctx) is not None
    for driver in ("fused_scoring", "fresh_scoring", "layout_scoring", "verifier_training"):
        assert read(dict(ctx, driver=driver)) is None
    expected = {"horizon_ms_per_pano": 5.0, "horizon_mfu_pct": 100 * 142.89784e9 / 5e-3 / 67e12,
                "horizon_host_ms_per_floor": 1.0, "boundary_host_ms_per_floor": 1.0,
                "device_idle_pct.horizon": 50.0}
    assert read(ctx) == pytest.approx(expected[metric], rel=1e-6)
