"""Whole runs of each driver at a tiny size on the CPU: the port against the
plain reference, the control (the reference at float8 in the program's
place) and planted faults, which must each come out not correct, and the
result line's keys.

The tiny sizes have their own readings (a ResNet-50 trunk at 56 px, 101^2
renders of 64x128 panos, batch 8), so the limits here are set from them,
as the configurations' limits are from the card's readings at full size:
logit_gap read 0.013-0.022 sound (6 seeds) and 0.135-0.236 under the
control (4 seeds); the training readings 0.011 / 0.065 / 0.049 sound and
0.14 / 0.14 / 0.071 under it.
"""

import time

import pytest
import torch

from benchmark import harness
from benchmark.drivers import fused_scoring, verifier_training

INFER = {"num_layers": 50, "n_images": 4, "num_classes": 2,
         "modalities": ["ceiling_rgb_texture", "floor_rgb_texture"], "compute_dtype": "bfloat16",
         "img_px": 100, "meters_per_px": 0.04, "resize_px": 58, "crop_px": 56, "batch_size": 8,
         "use_warp_renders": True, "limits": {"logit_gap": 0.06}}
FLOORS = {"driver": "fused_scoring", "panos_per_floor": [3, 4], "hypotheses_per_pair": 2, "theta_deg": [-180, 180],
          "t_m": [-2, 2], "scale": 1.0, "pool_panos": 6, "pano_hw": [64, 128], "floors": 4, "trace_floors": 2,
          "reference_floors": 2, "reference_hypotheses": 12}
TRAIN = {"num_layers": 50, "n_images": 4, "num_classes": 2,
         "modalities": ["ceiling_rgb_texture", "floor_rgb_texture"], "compute_dtype": "bfloat16",
         "resize_px": 58, "crop_px": 56, "batch_size": 8, "base_lr": 1e-3, "weight_decay": 1e-4,
         "poly_lr_power": 0.9, "num_epochs": 50, "print_every": 10, "deterministic_training": True,
         "optimizer": "adam", "lr_annealing_strategy": "poly", "apply_photometric_augmentation": False,
         "limits": {"logit_gap": 0.05, "grad_gap": 0.03, "change_gap": 0.3}}
STEPS = {"driver": "verifier_training", "corpus_tuples": 32, "trace_steps": 2}
SEED = 2**31 + 5


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def spec(config, mix, e2e):
    return {"config": config, "mix": mix, "per_layer": [],
            "end_to_end": [{"name": e2e, "unit": "x"}, {"name": "setup_s", "unit": "s"}]}


def run(config, mix, e2e, trace=False, seconds=1.0):
    return harness.run_cell(spec(config, mix, e2e), SEED, seconds, trace, "cpu", time.perf_counter())


def test_scoring_agrees_with_the_reference_and_the_line_has_its_keys():
    out = run(INFER, FLOORS, "hyp_per_s")
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"hyp_per_s", "setup_s"}
    line = harness.result_line(out, False, 1, "cpu", {"name": "cpu", "power_limit": "none"})
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "card", "checks"]
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert line["checks"]["logit_gap"]["limit"] == INFER["limits"]["logit_gap"]


def test_traced_scoring_agrees_and_carries_busy_window_and_breakdown():
    out = run(INFER, FLOORS, "hyp_per_s", trace=True)
    assert out["correct"], out["checks"]
    line = harness.result_line(out, True, 1, "cpu", {"name": "cpu", "power_limit": "none"})
    assert list(line)[-1] == "checks" and "breakdown" in line
    assert {"busy_s", "window_s"} <= set(line["device"]) and line["device"]["window_s"] > 0
    assert out["res"]["ctx"]["plain_window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_scoring_control_is_not_correct():
    checks = fused_scoring.control(INFER, FLOORS, SEED, "cpu", n_floors=2)
    assert checks["logit_gap"] > INFER["limits"]["logit_gap"]


def test_an_answer_altered_where_it_is_produced_is_not_correct(monkeypatch):
    from salve_tpu_torch.pipeline import fused_inference

    score_batch = fused_inference.score_batch

    def altered(*a, **k):
        y_hat, prob = score_batch(*a, **k)
        return 1 - y_hat, prob

    monkeypatch.setattr(fused_inference, "score_batch", altered)
    out = run(INFER, FLOORS, "hyp_per_s")
    assert not out["correct"]


def test_training_agrees_with_the_reference():
    out = run(TRAIN, STEPS, "train_tuples_per_s")
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"train_tuples_per_s", "setup_s"}


def test_training_control_is_not_correct():
    checks = verifier_training.control(TRAIN, STEPS, SEED, "cpu")
    assert any(checks[k] > TRAIN["limits"][k] for k in checks), checks


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(monkeypatch):
    from salve_tpu_torch.training import train as train_lib

    monkeypatch.setattr(train_lib.OptaxAdam, "step", lambda self: setattr(self, "count", self.count + 1))
    out = run(TRAIN, STEPS, "train_tuples_per_s")
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    from salve_tpu_torch.training import train as train_lib

    class HalfBatch:
        def __getattr__(self, name):
            return getattr(torch.nn.functional, name)

        @staticmethod
        def cross_entropy(logits, labels, reduction="mean"):
            half = logits.shape[0] // 2
            return torch.nn.functional.cross_entropy(logits[:half], labels[:half], reduction=reduction)

    monkeypatch.setattr(train_lib, "F", HalfBatch())
    out = run(TRAIN, STEPS, "train_tuples_per_s")
    assert not out["correct"]


def test_the_reference_switches_tf32_off_and_restores_the_process_settings():
    from benchmark.reference.model import fp32_products

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with fp32_products():
            assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_no_card_means_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = harness.main(["--workload", "infer-small-floors", "--seed", "1", "--seconds", "1", "--trace", "0"], 0.0)
    assert rc == 3
    assert capsys.readouterr().out == ""


@pytest.mark.card
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = harness.run_cell(harness.load_cell("infer-small-floors"), 7, 2.0, False, None, time.perf_counter())
    assert out["correct"], out["checks"]
