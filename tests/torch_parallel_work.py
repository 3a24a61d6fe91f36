"""What each rank of tests/test_torch_parallel.py runs: the port on a gloo
mesh on the CPU. Started by `salve_tpu_torch.parallel.launch`, so this
module imports the port only (no jax, no salve_tpu): each rank returns
plain tensors, arrays and lists, which the test holds to salve_tpu's mesh.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from salve_tpu_torch.device import deterministic_algorithms
from salve_tpu_torch.models.early_fusion import EarlyFusionCEResnet
from salve_tpu_torch.parallel.mesh import make_mesh, shard_batch
from salve_tpu_torch.pipeline.fused_inference import score_floor_hypotheses
from salve_tpu_torch.rendering.bev_pair import BEVRenderConfig
from salve_tpu_torch.training import device_corpus as tdc
from salve_tpu_torch.training import loop as tloop
from salve_tpu_torch.training import train as ttrain
from salve_tpu_torch.training import transforms as tt
from salve_tpu_torch.training.config import TrainingConfig
from salve_tpu_torch.utils import profiler

CPU = torch.device("cpu")


class FakeDataset:
    """A BEVPairDataset stand-in: tuple i's pixels are the constant i % 251."""

    def __init__(self, args, n, n_imgs=2):
        self.args = args
        self.data_list = [(f"img_{i}_a.jpg", f"img_{i}_b.jpg", i % 2) for i in range(n)]
        self.n_imgs = n_imgs

    def __len__(self):
        return len(self.data_list)

    def _load_tuples(self, tuples):
        a = self.args
        out = np.empty((len(tuples), self.n_imgs, a.resize_h, a.resize_w, 3), np.uint8)
        for j, t in enumerate(tuples):
            out[j] = int(t[0].split("_")[1]) % 251
        return out


class HostBatches:
    """A host-streamed split of given batches (imgs, labels, tuples)."""

    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return sum(len(b[1]) for b in self.batches)

    def iter_batches(self, batch_size, shuffle, seed=0):
        return iter(self.batches)


def _state_out(state) -> dict:
    names = state.param_names()
    return {
        "model": {k: v.detach().clone() for k, v in state.model.state_dict().items()},
        "grads": {n: p.grad.detach().clone() for n, p in state.model.named_parameters()},
        "mu": {n: t.clone() for n, t in zip(names, state.optimizer.mu)},
        "nu": {n: t.clone() for n, t in zip(names, state.optimizer.nu)},
        "step": state.step,
        "count": state.optimizer.count,
    }


def _port_state(cfg: TrainingConfig, weights: dict, max_iter: int):
    state = ttrain.create_train_state(cfg, torch.Generator().manual_seed(1), max_iter, CPU)
    state.model.load_state_dict(weights, strict=True)
    return state


def _popping(draws: list):
    """A draw_augment_params that returns the given (global-batch) draws in order."""
    def draw(gen, b, *args, **kwargs):
        got = draws.pop(0)
        assert got.off_h.shape[0] == b, (got.off_h.shape, b)
        return got
    return draw


def score(inp: dict, mesh) -> dict:
    model = EarlyFusionCEResnet(num_layers=18, compute_dtype="float32")
    model.load_state_dict(inp["weights"], strict=True)
    cfg, render_cfg = TrainingConfig(**inp["tiny"]), BEVRenderConfig(**inp["render"])
    out = {}
    for warp in (True, False):
        args = (model, cfg, inp["depths"], inp["rgbs"], {3: 0, 5: 1}, inp["hyps"])
        kw = dict(batch_size=inp["batch"], render_cfg=render_cfg, use_warp_renders=warp)
        res = score_floor_hypotheses(*args, **kw, mesh=mesh)
        # The one-device scorer at the per-rank batch over this rank's rows
        # of each padded batch: what each rank of the mesh computed.
        b, k = inp["batch"], inp["batch"] // mesh.size
        hyps = inp["hyps"]
        mine = []
        for s in range(0, len(hyps), b):
            chunk = hyps[s : s + b]
            mine += shard_batch(mesh, chunk + [chunk[-1]] * (b - len(chunk)))
        one = score_floor_hypotheses(*args[:5], mine, **dict(kw, batch_size=k), device="cpu")
        out["warp" if warp else "direct"] = {"results": [tuple(r) for r in res], "own_rows": [tuple(r) for r in one]}
    try:
        score_floor_hypotheses(model, cfg, inp["depths"], inp["rgbs"], {3: 0, 5: 1}, inp["hyps"],
                               batch_size=mesh.size + 1, render_cfg=render_cfg, mesh=mesh)
    except ValueError as e:
        out["not_divisible"] = str(e)
    return out


def score_layout(inp: dict, mesh) -> dict:
    """A layout verifier's floor on the mesh and, at the per-rank batch, the
    one-device scorer over this rank's rows, with the rasters this rank drew."""
    torch.manual_seed(0)
    modalities = ("ceiling_rgb_texture", "floor_rgb_texture", "layout")
    model = EarlyFusionCEResnet(num_layers=18, modalities=modalities, compute_dtype="float32").eval()
    cfg = TrainingConfig(**dict(inp["tiny"], modalities=modalities))
    args = (model, cfg, inp["depths"], inp["rgbs"], {3: 0, 5: 1})
    kw = dict(render_cfg=BEVRenderConfig(**inp["render"]), use_warp_renders=False, layouts=inp["layouts"])
    before = profiler.counter("layout/rasters")
    res = score_floor_hypotheses(*args, inp["hyps"], batch_size=inp["batch"], mesh=mesh, **kw)
    drawn = profiler.counter("layout/rasters") - before
    b, k = inp["batch"], inp["batch"] // mesh.size
    mine = []
    for s in range(0, len(inp["hyps"]), b):
        chunk = inp["hyps"][s : s + b]
        mine += shard_batch(mesh, chunk + [chunk[-1]] * (b - len(chunk)))
    one = score_floor_hypotheses(*args, mine, batch_size=k, device="cpu", **kw)
    return {"results": [tuple(r) for r in res], "own_rows": [tuple(r) for r in one], "rasters": drawn}


def corpus(inp: dict, mesh) -> dict:
    args = TrainingConfig(resize_h=6, resize_w=5)
    out = {}
    for n, batch in inp["corpus_cases"]:
        got = tdc.DeviceCorpus(FakeDataset(args, n), CPU, mesh)
        for shuffle, seed in ((True, 0), (True, 5), (False, 0)):
            out[(n, batch, shuffle, seed)] = [(i.numpy(), l, t, v) for i, l, t, v in
                                              got.iter_batches(batch, shuffle=shuffle, seed=seed)]
        out[(n, "shard_rows")] = got.corpus.shape[0]
    try:
        next(got.iter_batches(mesh.size + 1, shuffle=False))
    except ValueError as e:
        out["not_divisible"] = str(e)
    try:
        next(got.iter_batches(mesh.size * (got.shard_size + 1), shuffle=False))
    except ValueError as e:
        out["too_small"] = str(e)
    return out


def train_steps(inp: dict, mesh) -> dict:
    out = {}
    imgs, labels = inp["imgs"], inp["labels"]
    for balanced, aug in inp["steps"]:
        cfg = TrainingConfig(**dict(inp["small"], class_balanced_loss=balanced))
        state = _port_state(cfg, inp["weights_small"], 10)
        state, m = ttrain.make_train_step(cfg, mesh)(state, *shard_batch(mesh, (imgs, labels)), aug)
        out[balanced] = {"state": _state_out(state), "loss": float(m["loss"]), "accuracy": float(m["accuracy"]),
                         "probs": m["probs"].clone()}
    # A batch the mesh divides, then a tail batch it does not, through the loop.
    cfg = TrainingConfig(**inp["small"])
    state = _port_state(cfg, inp["weights_small"], 10)
    steps = (ttrain.make_train_step(cfg, mesh), ttrain.make_train_step(cfg))
    draws = list(inp["tail_draws"])
    saved = tt.draw_augment_params
    tt.draw_augment_params = _popping(draws)
    try:
        with deterministic_algorithms():
            state, metrics = tloop.run_epoch(cfg, 0, state, steps, HostBatches(inp["tail_batches"]), "train",
                                             gen=torch.Generator(), mesh=mesh)
    finally:
        tt.draw_augment_params = saved
    out["tail"] = {"state": _state_out(state), "metrics": metrics, "draws_left": len(draws)}
    return out


def train_and_evaluate(inp: dict, mesh) -> dict:
    """train() for 2 epochs and evaluate() on the test split; each rank
    counts the files it writes."""
    cfg = TrainingConfig(**inp["train_cfg"])
    draws = list(inp["train_draws"])
    writes = []
    saved = (tt.draw_augment_params, tloop.save_json_file, ttrain.save_checkpoint, ttrain.save_results_json)

    def counted(fn):
        def wrapper(*args, **kwargs):
            writes.append(fn.__name__)
            return fn(*args, **kwargs)
        return wrapper

    tt.draw_augment_params = _popping(draws)
    tloop.save_json_file, ttrain.save_checkpoint, ttrain.save_results_json = (counted(f) for f in saved[1:])
    try:
        results = tloop.train(cfg, seed=0, resume_from=inp["start_ckpt"], device="cpu")
        preds = Path(inp["eval_dir"])
        prec_rec_macc = tloop.evaluate(cfg, inp["start_ckpt"], "test", str(preds), device="cpu")
    finally:
        tt.draw_augment_params, tloop.save_json_file, ttrain.save_checkpoint, ttrain.save_results_json = saved
    return {"results": results, "draws_left": len(draws), "evaluate": prec_rec_macc, "writes": writes}


def world(inp: dict) -> dict:
    """Every part the test holds against salve_tpu, on this rank."""
    mesh = make_mesh(device="cpu")
    out = {"rank": mesh.rank, "size": mesh.size, "seconds": {}}
    for part in inp["parts"]:
        t0 = time.perf_counter()
        out[part] = globals()[part](inp, mesh)
        out["seconds"][part] = time.perf_counter() - t0
    return out
