"""The scorer's verifier as a CUDA graph (pipeline/fused_inference.py:
`run_verifier`): eager on the CPU, keyed by the batch's shape and the
parameters' storage, and on the card replayed with the answers of the eager
verifier on the same batches.

The CPU tests run everywhere. The tests marked `card` skip without a CUDA
card; on the card, with no JAX installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_verifier_graph.py
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from salve_tpu_torch.common.alignment_hypothesis import AlignmentHypothesis
from salve_tpu_torch.geometry.sim2 import Sim2
from salve_tpu_torch.models.early_fusion import EarlyFusionCEResnet
from salve_tpu_torch.pipeline import fused_inference
from salve_tpu_torch.pipeline.fused_inference import (
    batch_key,
    parameter_key,
    run_verifier,
    score_floor_hypotheses,
    graph_key,
)
from salve_tpu_torch.rendering.bev_pair import BEVRenderConfig
from salve_tpu_torch.training.config import TrainingConfig
from salve_tpu_torch.utils import profiler
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = dict(num_layers=18, resize_h=64, resize_w=64, train_h=56, train_w=56,
            modalities=("ceiling_rgb_texture", "floor_rgb_texture"), compute_dtype="bfloat16")
PANOS, HW, BATCH = 3, (64, 128), 4
COUNTERS = ("verifier/graph_captures", "verifier/graph_replays", "verifier/eager")


def hypotheses(n):
    return [(0, 1 + k % 2, AlignmentHypothesis(i2Ti1=Sim2.from_theta_deg(20.0 * k, np.array([0.1 * k, 0.2])),
                                               wdo_alignment_object="door", i1_wdo_idx=k, i2_wdo_idx=0,
                                               configuration="identity"))
            for k in range(n)]


def make_model(seed=0):
    torch.manual_seed(seed)
    return EarlyFusionCEResnet(num_layers=18, compute_dtype="bfloat16")


def banks():
    rng = np.random.default_rng(0)
    depths = rng.uniform(1000, 4000, (PANOS, *HW)).astype(np.uint16)
    rgbs = rng.uniform(0, 1, (PANOS, *HW, 3)).astype(np.float32)
    return depths, rgbs


def score(model, n_hyps, device, batch_size=BATCH, **kw):
    depths, rgbs = banks()
    return score_floor_hypotheses(model, TrainingConfig(**TINY), depths, rgbs, {0: 0, 1: 1, 2: 2},
                                  hypotheses(n_hyps), batch_size=batch_size,
                                  render_cfg=BEVRenderConfig(img_px=100, meters_per_px=0.1),
                                  use_warp_renders=True, device=device, **kw)


def counted(fn):
    """fn()'s result and what it added to each verifier counter."""
    before = {n: profiler.counter(n) for n in COUNTERS}
    out = fn()
    return out, {n.split("/")[1]: profiler.counter(n) - before[n] for n in COUNTERS}


def log_odds(y_hat, prob):
    p1 = torch.where(y_hat == 1, prob, 1.0 - prob).double().clamp(1e-7, 1 - 1e-7)
    return torch.log(p1) - torch.log1p(-p1)


# --- on the CPU ---------------------------------------------------------------


def test_a_cpu_floor_is_scored_eagerly_once_a_batch(tmp_path):
    model = make_model()
    n_hyps = 3 * BATCH - 1
    _, added = counted(lambda: score(model, n_hyps, "cpu"))
    assert added == {"graph_captures": 0, "graph_replays": 0, "eager": 3}
    with profiler.device_trace(str(tmp_path)):
        score(model, n_hyps, "cpu")
    verifier = [s for s in profiler.span_record() if s["name"] == "salve/verifier"]
    assert [s["counts"] for s in verifier] == [{"verifier/eager": 1}] * 3
    assert model not in fused_inference._GRAPHS


def test_the_key_follows_the_batch_shape_and_the_parameters_storage_not_their_values():
    model = make_model().eval()
    key = parameter_key(model)
    assert len(key) == len(list(model.parameters())) + len(list(model.buffers()))
    with torch.no_grad():
        model.fc.weight.mul_(2)
        model.resnet.bn1.running_mean.add_(1)
    assert parameter_key(model) == key
    model.fc.weight = torch.nn.Parameter(model.fc.weight.detach().clone())
    replaced = parameter_key(model)
    assert replaced != key and sum(a != b for a, b in zip(key, replaced)) == 1
    model.load_state_dict({n: t.clone() for n, t in model.state_dict().items()}, assign=True)
    assert all(a != b for a, b in zip(replaced, parameter_key(model)))

    batch = torch.zeros(BATCH, 4, 8, 8, 3)
    assert batch_key(batch) == batch_key(torch.ones_like(batch))
    assert batch_key(batch) != batch_key(torch.zeros(BATCH + 1, 4, 8, 8, 3))
    assert batch_key(batch) != batch_key(batch.double())
    # Off the card, or with a module in training mode, the verifier runs eagerly.
    assert graph_key(model) == ()
    assert graph_key(model.train()) == ()


def test_a_cpu_floor_scores_the_same_before_and_after_the_key_is_computed():
    model = make_model()
    before = score(model, 2 * BATCH + 1, "cpu")
    parameter_key(model)
    assert graph_key(model) == ()
    assert score(model, 2 * BATCH + 1, "cpu") == before


def test_a_cpu_batch_runs_the_verifier_eagerly_whatever_the_key():
    model = make_model().eval()
    batch = torch.rand(2, 4, 56, 56, 3)
    key = (1, 2, 3)  # a key as the card gives one: the batch itself keeps the verifier eager
    with torch.no_grad():
        (y_hat, prob), added = counted(lambda: run_verifier(model, batch, key))
        y_ref, p_ref = fused_inference._verify(model, batch)
    assert added == {"graph_captures": 0, "graph_replays": 0, "eager": 1}
    assert torch.equal(y_hat, y_ref) and torch.equal(prob, p_ref)


# --- on the card ----------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from salve_tpu_torch.device import resolve_device

    return resolve_device(None)


@pytest.mark.card
@pytest.mark.parametrize("n_batches", [1, 2, 5])
def test_replays_equal_the_eager_verifier_on_the_same_batches(card, monkeypatch, n_batches):
    seen = []

    def recording(model, batch, key):
        out = run_verifier(model, batch, key)
        seen.append((batch.clone(), key, out))
        return out

    monkeypatch.setattr(fused_inference, "run_verifier", recording)
    model = make_model()
    results, added = counted(lambda: score(model, n_batches * BATCH - 1, card))
    assert added == {"graph_captures": 1, "graph_replays": n_batches, "eager": 0}
    assert len(seen) == n_batches and len(results) == n_batches * BATCH - 1
    with torch.no_grad():
        for batch, key, (y_hat, prob) in seen:
            assert key == graph_key(model) != ()
            y_ref, p_ref = fused_inference._verify(model, batch)
            assert torch.equal(y_hat, y_ref)
            assert float((log_odds(y_hat, prob) - log_odds(y_ref, p_ref)).abs().max()) <= 0.01


@pytest.mark.card
def test_one_capture_serves_every_batch_of_a_shape_and_a_second_shape_captures_again(card):
    model = make_model()
    _, added = counted(lambda: score(model, 3 * BATCH, card))
    assert added == {"graph_captures": 1, "graph_replays": 3, "eager": 0}
    _, added = counted(lambda: score(model, 3 * BATCH, card))
    assert added == {"graph_captures": 0, "graph_replays": 3, "eager": 0}
    _, added = counted(lambda: score(model, 3 * BATCH, card, batch_size=2 * BATCH))
    assert added == {"graph_captures": 1, "graph_replays": 2, "eager": 0}
    assert len(fused_inference._GRAPHS[model][1]) == 2


def _card_batches(card, n):
    gen = torch.Generator(device=card).manual_seed(11)
    return [torch.randn(BATCH, 4, 56, 56, 3, device=card, generator=gen) for _ in range(n)]


@pytest.mark.card
@torch.no_grad()
def test_a_replaced_parameter_captures_anew_and_the_answer_follows_it(card):
    model = make_model().to(card).eval()
    (batch,) = _card_batches(card, 1)
    key = graph_key(model)
    (_, p_old), added = counted(lambda: run_verifier(model, batch, key))
    assert added["graph_captures"] == 1
    model.fc.weight = torch.nn.Parameter(-model.fc.weight.detach())
    new_key = graph_key(model)
    assert new_key != key
    (y_hat, prob), added = counted(lambda: run_verifier(model, batch, new_key))
    assert added == {"graph_captures": 1, "graph_replays": 1, "eager": 0}
    y_ref, p_ref = fused_inference._verify(model, batch)
    assert torch.equal(y_hat, y_ref) and torch.equal(prob, p_ref)
    assert not torch.equal(prob, p_old)
    assert len(fused_inference._GRAPHS[model][1]) == 1  # the graph of the old storage went


@pytest.mark.card
@torch.no_grad()
def test_a_value_changed_in_place_is_read_by_the_next_replay_without_a_capture(card):
    model = make_model().to(card).eval()
    (batch,) = _card_batches(card, 1)
    key = graph_key(model)
    (_, p_old), _ = counted(lambda: run_verifier(model, batch, key))
    model.fc.weight.mul_(2)
    assert graph_key(model) == key
    (y_hat, prob), added = counted(lambda: run_verifier(model, batch, key))
    assert added == {"graph_captures": 0, "graph_replays": 1, "eager": 0}
    y_ref, p_ref = fused_inference._verify(model, batch)
    assert torch.equal(y_hat, y_ref) and torch.equal(prob, p_ref)
    assert not torch.equal(prob, p_old)
    # With grad on, or in training mode, the same model runs eagerly.
    with torch.enable_grad():
        _, added = counted(lambda: run_verifier(model, batch, key))
    assert added == {"graph_captures": 0, "graph_replays": 0, "eager": 1}
    assert graph_key(model.train()) == ()


@pytest.mark.card
@torch.no_grad()
def test_the_answers_of_one_batch_survive_the_next_replay(card):
    model = make_model().to(card).eval()
    a, b = _card_batches(card, 2)
    key = graph_key(model)
    y_a, p_a = run_verifier(model, a, key)
    kept = y_a.clone(), p_a.clone()
    run_verifier(model, b, key)
    torch.cuda.synchronize()
    assert torch.equal(y_a, kept[0]) and torch.equal(p_a, kept[1])
    y_ref, p_ref = fused_inference._verify(model, a)
    assert torch.equal(y_a, y_ref) and torch.equal(p_a, p_ref)


@pytest.mark.card
def test_a_model_takes_its_graphs_with_it(card):
    model = make_model()
    score(model, BATCH, card)
    assert model in fused_inference._GRAPHS
    ref = weakref.ref(model)
    n = len(fused_inference._GRAPHS)
    del model
    gc.collect()
    assert ref() is None and len(fused_inference._GRAPHS) == n - 1


@pytest.mark.card
def test_a_mesh_world_of_one_on_the_card_equals_the_unsharded_scorer(card, tmp_path):
    import torch.distributed as dist

    from salve_tpu_torch.parallel.mesh import make_mesh

    model = make_model()
    alone = score(model, 3 * BATCH - 1, card)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0)
    try:
        mesh = make_mesh()
        assert mesh.group is not None and mesh.backend == "nccl"
        (sharded, added) = counted(lambda: score(model, 3 * BATCH - 1, None, mesh=mesh))
    finally:
        dist.destroy_process_group()
    assert sharded == alone
    assert added == {"graph_captures": 0, "graph_replays": 3, "eager": 0}
