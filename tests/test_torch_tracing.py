"""The port's spans and counters (salve_tpu_torch/utils/profiler.py) on the
scorer and the train step: off without a profiler, nested as the layers
are under one, counted from shapes, on the trace's clock, and one profiled
stretch at a time. CPU only, at tiny sizes."""

import json

import numpy as np
import pytest
import torch

from salve_tpu_torch import device as device_mod
from salve_tpu_torch.common.alignment_hypothesis import AlignmentHypothesis
from salve_tpu_torch.geometry.sim2 import Sim2
from salve_tpu_torch.models.early_fusion import EarlyFusionCEResnet
from salve_tpu_torch.pipeline.fused_inference import score_floor_hypotheses
from salve_tpu_torch.rendering.bev_pair import BEVRenderConfig
from salve_tpu_torch.training import loop, train
from salve_tpu_torch.training.config import TrainingConfig
from salve_tpu_torch.utils import profiler
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = dict(num_layers=18, resize_h=64, resize_w=64, train_h=56, train_w=56,
            modalities=("ceiling_rgb_texture", "floor_rgb_texture"), compute_dtype="float32")
SMALL = dict(num_layers=18, resize_h=40, resize_w=40, train_h=32, train_w=32, batch_size=8,
             compute_dtype="float32", print_every=1)
PANOS, HW, BATCH, N_HYPS = 3, (64, 128), 2, 5
FLOOR_SPANS = ("salve/place", "salve/upload", "salve/banks")
BATCH_SPANS = ("salve/prepare", "salve/warp", "salve/preprocess", "salve/verifier", "salve/fetch", "salve/collect")
STEP_SPANS = ("salve/augment", "salve/forward", "salve/backward", "salve/optimizer")


@pytest.fixture(scope="module")
def floor():
    model = EarlyFusionCEResnet(num_layers=18, compute_dtype="float32")
    rng = np.random.default_rng(0)
    depths = rng.uniform(1000, 4000, (PANOS, *HW)).astype(np.uint16)
    rgbs = rng.uniform(0, 1, (PANOS, *HW, 3)).astype(np.float32)
    hyps = [(0, 1 + k % 2, AlignmentHypothesis(i2Ti1=Sim2.from_theta_deg(20.0 * k, np.array([0.1 * k, 0.2])),
                                               wdo_alignment_object="door", i1_wdo_idx=k, i2_wdo_idx=0,
                                               configuration="identity"))
            for k in range(N_HYPS)]

    def score():
        return score_floor_hypotheses(model, TrainingConfig(**TINY), depths, rgbs, {0: 0, 1: 1, 2: 2}, hyps,
                                      batch_size=BATCH, render_cfg=BEVRenderConfig(img_px=100, meters_per_px=0.1),
                                      use_warp_renders=True, device="cpu")

    return score


@pytest.fixture(scope="module")
def traced_floor(floor, tmp_path_factory):
    """One floor scored under `device_trace`: (record, trace.json, spans.json)."""
    floor()
    out = tmp_path_factory.mktemp("trace")
    with profiler.device_trace(str(out)):
        floor()
    return profiler.span_record(), json.loads((out / "trace.json").read_text()), \
        json.loads((out / "spans.json").read_text())


def children(record, i):
    return [s["name"] for s in record if s["parent"] == i]


def test_a_span_without_a_profiler_is_the_shared_noop(floor):
    assert not torch.autograd._profiler_enabled()
    assert profiler.annotate("floor", id=1, panos=3) is profiler.NOOP
    profiler.reset_span_record()
    floor()
    with profiler.annotate("x"):
        profiler.count("tracing_test_total", 2)
    assert profiler.span_record() == []
    assert profiler.counter("tracing_test_total") >= 2


def test_a_traced_floor_has_every_span_once_a_floor_or_batch_nested_with_one_floor_id(traced_floor):
    record, _, _ = traced_floor
    n_batches = -(-N_HYPS // BATCH)
    roots = [i for i, s in enumerate(record) if s["parent"] is None]
    assert [record[i]["name"] for i in roots] == ["salve/floor"]
    assert children(record, roots[0]) == list(FLOOR_SPANS) + ["salve/batch"] * n_batches
    batches = [i for i, s in enumerate(record) if s["name"] == "salve/batch"]
    for i in batches:
        assert children(record, i) == list(BATCH_SPANS)
    assert len(record) == 1 + len(FLOOR_SPANS) + n_batches * (1 + len(BATCH_SPANS))
    assert {s["id"] for s in record} == {record[0]["id"]} and isinstance(record[0]["id"], int)
    assert all(s["start_ns"] <= s["end_ns"] for s in record)
    for s in record[1:]:
        parent = record[s["parent"]]
        assert parent["start_ns"] <= s["start_ns"] and s["end_ns"] <= parent["end_ns"]


def test_counts_equal_what_the_shapes_give(traced_floor):
    record, _, _ = traced_floor
    by = {}
    for s in record:
        by.setdefault(s["name"], []).append(s["counts"])
    assert by["salve/floor"] == [{"panos": PANOS, "hypotheses": N_HYPS}]
    # The fixture's first floor put the model in eval: the traced one finds it placed.
    assert by["salve/place"] == [{"models/resident": 1}]
    pixels = PANOS * HW[0] * HW[1]
    assert by["salve/upload"] == [{"panos": PANOS, "h2d_bytes": pixels * 4 + pixels * 3 * 4}]
    assert [c["rows"] for c in by["salve/batch"]] == [BATCH] * 3
    assert [c["padded_rows"] for c in by["salve/batch"]] == [0, 0, 1]
    # Two int64 index rows, a 2x2 float32 rotation and a float32 translation a row.
    assert by["salve/prepare"] == [{"h2d_bytes": BATCH * (8 + 8 + 16 + 8)}] * 3
    # An int64 label and a float32 probability a row.
    assert by["salve/fetch"] == [{"d2h_bytes": BATCH * (8 + 4)}] * 3


def test_every_span_in_spans_json_is_in_the_trace_on_its_clock(traced_floor):
    record, trace, spans = traced_floor
    assert spans["spans"] == record
    assert spans["counters"]["hypotheses"] >= N_HYPS
    base = trace.get("baseTimeNanoseconds", 0)
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X" and e.get("name", "").startswith("salve/")]
    assert len(events) == len(record)
    for s in record:
        start_us, dur_us = (s["start_ns"] - base) / 1e3, (s["end_ns"] - s["start_ns"]) / 1e3
        near = [e for e in events if e["name"] == s["name"] and abs(e["ts"] - start_us) < 100.0]
        assert len(near) == 1, s["name"]
        assert abs(near[0]["dur"] - dur_us) < 100.0, s["name"]


@pytest.mark.parametrize("session", ["device_trace", "torch_profile"])
def test_two_profiled_stretches_leave_only_the_second(floor, tmp_path, session):
    def stretch(k):
        if session == "device_trace":
            with profiler.device_trace(str(tmp_path / str(k))):
                floor()
        else:
            floor()  # untraced work between two sessions of the caller's own
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
                floor()

    stretch(0)
    first = profiler.span_record()[0]["id"]
    stretch(1)
    record = profiler.span_record()
    assert [s["name"] for s in record].count("salve/floor") == 1
    assert record[0]["id"] > first and {s["id"] for s in record} == {record[0]["id"]}


def test_a_train_step_has_its_four_phases_inside_it(tmp_path):
    cfg = TrainingConfig(**SMALL)
    state = train.create_train_state(cfg, torch.Generator().manual_seed(3), 10, torch.device("cpu"))
    step = train.make_train_step(cfg)
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (8, 4, 40, 40, 3), dtype=np.uint8)
    labels = np.array([0, 1, 1, 0, 0, 0, 1, 0], np.int32)
    state.step = 7
    with profiler.device_trace(str(tmp_path)):
        step(state, imgs, labels, torch.Generator().manual_seed(5))
    record = profiler.span_record()
    assert record[0]["name"] == "salve/step" and record[0]["parent"] is None and record[0]["id"] == 7
    assert children(record, 0) == list(STEP_SPANS)
    assert len(record) == 1 + len(STEP_SPANS) and {s["id"] for s in record} == {7}


class _Batches:
    """What `run_epoch` reads of a dataset: batches of (imgs, labels, tuples)."""

    def __init__(self, n):
        rng = np.random.default_rng(1)
        self.batches = [(rng.integers(0, 256, (8, 4, 40, 40, 3), dtype=np.uint8),
                         rng.integers(0, 2, 8).astype(np.int32), [None] * 8) for _ in range(n)]

    def iter_batches(self, batch_size, shuffle, seed=0):
        yield from self.batches


def test_an_epoch_has_its_gather_steps_folds_and_syncs(tmp_path):
    cfg = TrainingConfig(**SMALL)
    state = train.create_train_state(cfg, torch.Generator().manual_seed(3), 10, torch.device("cpu"))
    step = train.make_train_step(cfg)
    with profiler.device_trace(str(tmp_path)):
        loop.run_epoch(cfg, 4, state, (step, step), _Batches(2), "train", gen=torch.Generator().manual_seed(5))
    record = profiler.span_record()
    assert record[0]["name"] == "salve/epoch" and record[0]["id"] == 4
    # print_every 1: a sync after every step, and the epoch's metrics last.
    assert children(record, 0) == ["salve/gather", "salve/step", "salve/fold", "salve/sync"] * 2 + \
        ["salve/gather", "salve/sync"]
    assert record[0]["counts"] == {"train_steps": 2, "train_tuples": 16}
    assert [s["id"] for s in record if s["name"] == "salve/step"] == [0, 1]


def test_launch_counts_read_b1_to_b3_as_before(tmp_path):
    device_mod.reset_launch_counts()
    assert device_mod.launch_counts() == {"splat": 0, "fill": 0, "warp": 0, "layout": 0}
    device_mod.count_launch("warp")
    device_mod.count_launch("warp")
    device_mod.count_launch("splat")
    assert device_mod.launch_counts() == {"splat": 1, "fill": 0, "warp": 2, "layout": 0}
    with profiler.device_trace(str(tmp_path)):
        with profiler.annotate("banks"):
            device_mod.count_launch("fill")
    assert profiler.span_record()[0]["counts"] == {"launches/fill": 1}
    assert device_mod.launch_counts() == {"splat": 1, "fill": 1, "warp": 2, "layout": 0}
    device_mod.reset_launch_counts()
    assert device_mod.launch_counts() == {"splat": 0, "fill": 0, "warp": 0, "layout": 0}


def test_stage_timer_opens_its_span_and_keeps_its_summary(tmp_path):
    profiler.reset_stage_timers()
    with profiler.device_trace(str(tmp_path)):
        with profiler.stage_timer("render/pano_load"):
            torch.ones(4).sum()
    assert [s["name"] for s in profiler.span_record()] == ["salve/render/pano_load"]
    assert "salve/render/pano_load" in (tmp_path / "trace.json").read_text()
    summary = profiler.stage_summary()["render/pano_load"]
    assert summary["count"] == 1 and summary["total_s"] == summary["mean_s"] > 0
    profiler.reset_stage_timers()
