"""The scorer's verifier as a CUDA graph (pipeline/fused_inference.py:
`run_graphed`): eager on the CPU, keyed by the batch's shape and the
parameters' storage as `place` found it, and on the card replayed with the
answers of the eager verifier on the same batches; and the scorer's
placement of its models (`place`): moved and put in eval where they are
not, used as they are where they are, with the same answers either way.

The CPU tests run everywhere. The tests marked `card` skip without a CUDA
card; on the card, with no JAX installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_verifier_graph.py
"""

import copy
import gc
import weakref

import numpy as np
import pytest
import torch

from salve_tpu_torch.common.alignment_hypothesis import AlignmentHypothesis
from salve_tpu_torch.geometry.sim2 import Sim2
from salve_tpu_torch.models.early_fusion import EarlyFusionCEResnet
from salve_tpu_torch.models.hohonet import seeded_hohonet
from salve_tpu_torch.pipeline import fused_inference
from salve_tpu_torch.pipeline.fused_inference import _verify, _walk, place, run_graphed, score_floor_hypotheses
from salve_tpu_torch.rendering.bev_pair import BEVRenderConfig
from salve_tpu_torch.training.config import TrainingConfig
from salve_tpu_torch.utils import profiler
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = dict(num_layers=18, resize_h=64, resize_w=64, train_h=56, train_w=56,
            modalities=("ceiling_rgb_texture", "floor_rgb_texture"), compute_dtype="bfloat16")
PANOS, HW, BATCH = 3, (64, 128), 4
COUNTERS = ("verifier/graph_captures", "verifier/graph_replays", "verifier/eager")
MODELS = ("models/resident", "models/placed")


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
    if kw.get("depth_model") is not None:
        depths = None
    return score_floor_hypotheses(model, TrainingConfig(**TINY), depths, rgbs, {0: 0, 1: 1, 2: 2},
                                  hypotheses(n_hyps), batch_size=batch_size,
                                  render_cfg=BEVRenderConfig(img_px=100, meters_per_px=0.1),
                                  use_warp_renders=True, device=device, **kw)


def counted(fn, names=COUNTERS):
    """fn()'s result and what it added to each counter of `names` (the
    verifier's by default)."""
    before = {n: profiler.counter(n) for n in names}
    out = fn()
    return out, {n.split("/")[1]: profiler.counter(n) - before[n] for n in names}


def parent_place(model, dev):
    """The placement the scorer made before `place`: `.to` and `.eval` on
    every floor."""
    return model.to(dev).eval()


def verify(model, batch):
    """The verifier through `run_graphed`, as `score_batch` runs it."""
    return run_graphed(_verify, model, batch, "verifier")


def entry(model):
    """The storage the model's `_GRAPHS` entry holds, None without one."""
    held = fused_inference._GRAPHS.get(model)
    return None if held is None else held[0]


def counting_to_and_train(monkeypatch):
    """The calls of `nn.Module.to` and `nn.Module.train` (which `eval` calls)
    made from here on, by name."""
    calls = []
    to, train = torch.nn.Module.to, torch.nn.Module.train

    def counting_to(self, *args, **kwargs):
        calls.append("to")
        return to(self, *args, **kwargs)

    def counting_train(self, mode=True):
        calls.append("train")
        return train(self, mode)

    monkeypatch.setattr(torch.nn.Module, "to", counting_to)
    monkeypatch.setattr(torch.nn.Module, "train", counting_train)
    return calls


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
    # The storage `place` records: the data pointer of each parameter and
    # buffer. (The batch's part of the key, its shape, dtype and device, is
    # read only on the card: test_graphs_are_keyed_by_the_inputs_shape_and_dtype_not_its_values.)
    model = make_model().eval()
    evaluating, devices, key = _walk(model)
    assert evaluating and devices == {torch.device("cpu")}
    assert len(key) == len(list(model.parameters())) + len(list(model.buffers()))
    with torch.no_grad():
        model.fc.weight.mul_(2)
        model.resnet.bn1.running_mean.add_(1)
    assert _walk(model)[2] == key
    model.fc.weight = torch.nn.Parameter(model.fc.weight.detach().clone())
    replaced = _walk(model)[2]
    assert replaced != key and sum(a != b for a, b in zip(key, replaced)) == 1
    model.load_state_dict({n: t.clone() for n, t in model.state_dict().items()}, assign=True)
    assert all(a != b for a, b in zip(replaced, _walk(model)[2]))
    # Off the card, or with a module in training mode, the model gets no
    # entry and the verifier runs eagerly.
    assert not _walk(model.train())[0]
    for mode in (model.eval, model.train):
        mode()
        assert place(model, torch.device("cpu")) is model and entry(model) is None
        with torch.no_grad():
            _, added = counted(lambda: verify(model, torch.rand(2, 4, 56, 56, 3)))
        assert added == {"graph_captures": 0, "graph_replays": 0, "eager": 1}


def test_a_cpu_floor_scores_the_same_before_and_after_the_key_is_computed():
    model = make_model()
    before = score(model, 2 * BATCH + 1, "cpu")
    assert place(model, torch.device("cpu")) is model and entry(model) is None
    assert score(model, 2 * BATCH + 1, "cpu") == before


@pytest.mark.parametrize("fresh", [False, True], ids=["depth_bank", "depth_model"])
def test_a_floor_places_its_models_once_and_then_finds_them_resident(monkeypatch, fresh):
    model = make_model()
    depth_model = seeded_hohonet(HW, seed=3).train() if fresh else None
    n_models = 2 if fresh else 1
    n_hyps = 2 * BATCH + 1
    with monkeypatch.context() as m:
        m.setattr(fused_inference, "place", parent_place)
        kept, kept_depth = copy.deepcopy(model), copy.deepcopy(depth_model)
        parent = [score(kept, n_hyps, "cpu", depth_model=kept_depth) for _ in range(2)]

    first, added = counted(lambda: score(model, n_hyps, "cpu", depth_model=depth_model), MODELS)
    assert added == {"resident": 0, "placed": n_models}
    assert not any(m.training for net in (model, depth_model) if net is not None for m in net.modules())
    calls = counting_to_and_train(monkeypatch)
    second, added = counted(lambda: score(model, n_hyps, "cpu", depth_model=depth_model), MODELS)
    assert added == {"resident": n_models, "placed": 0}
    assert calls == []
    assert [first, second] == parent


@pytest.mark.parametrize("why,dev", [("one_module_training", "cpu"), ("on_another_device", "meta")])
def test_place_moves_and_switches_a_model_found_out_of_place(why, dev):
    dev = torch.device(dev)
    model = make_model().eval()
    if why == "one_module_training":
        model.resnet.layer1[1].bn2.train()
    placed, added = counted(lambda: place(model, dev), MODELS)
    assert added == {"resident": 0, "placed": 1} and placed is model and entry(model) is None
    assert not any(m.training for m in model.modules())
    assert {t.device for t in model.state_dict().values()} == {dev}
    _, added = counted(lambda: place(model, dev), MODELS)
    assert added == {"resident": 1, "placed": 0}


def test_a_cpu_batch_runs_the_verifier_eagerly_whatever_the_key(monkeypatch):
    model = make_model().eval()
    batch = torch.rand(2, 4, 56, 56, 3)
    # An entry as `place` makes one on the card: the batch itself keeps the verifier eager.
    monkeypatch.setitem(fused_inference._GRAPHS, model, (_walk(model)[2], {}))
    with torch.no_grad():
        (y_hat, prob), added = counted(lambda: verify(model, batch))
        y_ref, p_ref = _verify(model, batch)
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

    def recording(body, model, batch, name):
        out = run_graphed(body, model, batch, name)
        seen.append((batch.clone(), entry(model), out))
        return out

    monkeypatch.setattr(fused_inference, "run_graphed", recording)
    model = make_model()
    results, added = counted(lambda: score(model, n_batches * BATCH - 1, card))
    assert added == {"graph_captures": 1, "graph_replays": n_batches, "eager": 0}
    assert len(seen) == n_batches and len(results) == n_batches * BATCH - 1
    with torch.no_grad():
        for batch, key, (y_hat, prob) in seen:
            assert key == _walk(model)[2]
            y_ref, p_ref = _verify(model, batch)
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


@pytest.mark.card
@pytest.mark.parametrize("between,captures", [("nothing", 0), ("a_parameter_replaced", 1),
                                              ("a_value_changed_in_place", 0)])
def test_a_resident_model_replays_on_its_next_floor_and_captures_only_for_new_storage(card, between, captures):
    model, twin = make_model(), make_model()
    score(model, 2 * BATCH, card)
    with torch.no_grad():
        if between == "a_parameter_replaced":
            model.fc.weight = torch.nn.Parameter(-model.fc.weight.detach())
        elif between == "a_value_changed_in_place":
            model.fc.weight.mul_(-1)
        if between != "nothing":
            twin.fc.weight.mul_(-1)
    results, added = counted(lambda: score(model, 2 * BATCH, card), COUNTERS + MODELS)
    assert added == {"graph_captures": captures, "graph_replays": 2, "eager": 0, "resident": 1, "placed": 0}
    # The same weights placed afresh (moved from the CPU) score alike.
    twins, added = counted(lambda: score(twin, 2 * BATCH, card), MODELS)
    assert added == {"resident": 0, "placed": 1}
    assert results == twins


@pytest.mark.card
@pytest.mark.parametrize("name", ["cuda", "cuda:<current>"])
def test_a_model_on_the_current_card_is_resident_whatever_the_card_is_called(card, name):
    index = torch.cuda.current_device()
    model = make_model().to(torch.device("cuda", index)).eval()
    dev = torch.device(name.replace("<current>", str(index)))
    placed, added = counted(lambda: place(model, dev), MODELS)
    assert added == {"resident": 1, "placed": 0}
    assert placed is model and entry(model) == _walk(model)[2]


def _card_batches(card, n):
    gen = torch.Generator(device=card).manual_seed(11)
    return [torch.randn(BATCH, 4, 56, 56, 3, device=card, generator=gen) for _ in range(n)]


@pytest.mark.card
@torch.no_grad()
def test_a_replaced_parameter_captures_anew_and_the_answer_follows_it(card):
    model = place(make_model(), card)
    (batch,) = _card_batches(card, 1)
    key = entry(model)
    (_, p_old), added = counted(lambda: verify(model, batch))
    assert added["graph_captures"] == 1
    model.fc.weight = torch.nn.Parameter(-model.fc.weight.detach())
    place(model, card)
    assert entry(model) == _walk(model)[2] != key
    (y_hat, prob), added = counted(lambda: verify(model, batch))
    assert added == {"graph_captures": 1, "graph_replays": 1, "eager": 0}
    y_ref, p_ref = _verify(model, batch)
    assert torch.equal(y_hat, y_ref) and torch.equal(prob, p_ref)
    assert not torch.equal(prob, p_old)
    assert len(fused_inference._GRAPHS[model][1]) == 1  # the graph of the old storage went


@pytest.mark.card
@torch.no_grad()
def test_a_value_changed_in_place_is_read_by_the_next_replay_without_a_capture(card):
    model = place(make_model(), card)
    (batch,) = _card_batches(card, 1)
    key = entry(model)
    (_, p_old), _ = counted(lambda: verify(model, batch))
    model.fc.weight.mul_(2)
    place(model, card)
    assert entry(model) == key and len(fused_inference._GRAPHS[model][1]) == 1
    (y_hat, prob), added = counted(lambda: verify(model, batch))
    assert added == {"graph_captures": 0, "graph_replays": 1, "eager": 0}
    y_ref, p_ref = _verify(model, batch)
    assert torch.equal(y_hat, y_ref) and torch.equal(prob, p_ref)
    assert not torch.equal(prob, p_old)
    # With grad on, or in training mode, the same model runs eagerly, its
    # entry kept.
    with torch.enable_grad():
        _, added = counted(lambda: verify(model, batch))
    assert added == {"graph_captures": 0, "graph_replays": 0, "eager": 1}
    model.train()
    _, added = counted(lambda: verify(model, batch))
    assert added == {"graph_captures": 0, "graph_replays": 0, "eager": 1}
    assert entry(model) == key


@pytest.mark.card
@torch.no_grad()
def test_the_answers_of_one_batch_survive_the_next_replay(card):
    model = place(make_model(), card)
    a, b = _card_batches(card, 2)
    (y_a, p_a), added = counted(lambda: verify(model, a))
    assert added == {"graph_captures": 1, "graph_replays": 1, "eager": 0}
    kept = y_a.clone(), p_a.clone()
    verify(model, b)
    torch.cuda.synchronize()
    assert torch.equal(y_a, kept[0]) and torch.equal(p_a, kept[1])
    y_ref, p_ref = _verify(model, a)
    assert torch.equal(y_a, y_ref) and torch.equal(p_a, p_ref)


@pytest.mark.card
@torch.no_grad()
def test_graphs_are_keyed_by_the_inputs_shape_and_dtype_not_its_values(card):
    model = place(torch.nn.Linear(8, 8), card)

    def body(m, x):
        return (m(x.float()),)

    x = torch.rand(BATCH, 8, device=card)
    others = [torch.rand_like(x), torch.rand(BATCH + 1, 8, device=card), x.double()]
    _, added = counted(lambda: run_graphed(body, model, x, "verifier"))
    assert added == {"graph_captures": 1, "graph_replays": 1, "eager": 0}
    for other, captures in zip(others, (0, 1, 1)):
        (got,), added = counted(lambda: run_graphed(body, model, other, "verifier"))
        assert added == {"graph_captures": captures, "graph_replays": 1, "eager": 0}
        torch.testing.assert_close(got, model(other.float()))
    assert len(fused_inference._GRAPHS[model][1]) == 3


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
