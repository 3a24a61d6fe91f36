"""Fused Stage B+C inference: render and verify hypotheses on the card.

Port of salve_tpu/pipeline/fused_inference.py. For each hypothesis batch:
render ceiling+floor texture-map pairs from the device-resident pano bank,
quantize to u8 (the domain the verifier was trained on), resize to the eval
resolution and score with the early-fusion CNN, with no image files and no
host round trip of images. Output is the per-hypothesis (y_hat, prob)
record Stage D consumes.

Kernels on this path: B1 (splat) and B2 (fill + mask) for the identity and
warp banks (in warp mode both of a surface from one backprojection,
rendering/bev_pair.py:render_identity_banks), and in warp mode B3 (shear
warp), one launch a batch for the ceiling and the floor; B1 and B2 per
hypothesis in direct mode.

On a mesh of N ranks (parallel/mesh.py; salve_tpu's shard_map scorer,
`make_fused_score_fn_sharded`) every rank renders the floor's banks itself,
scores its batch_size / N rows of each padded batch with the unmodified
one-card body, and the (y_hat, prob) of each batch are all-gathered, so
every rank returns the whole ordered list. No other collective runs.

The verifier (the model, the softmax, the predicted class and its
probability) runs on the card as one CUDA graph a batch shape: captured on
the first batch of a shape, after an eager warm-up, and replayed for every
later one, which the host launches at the cost of one copy in, one launch
and two small copies out instead of ResNet-152's several hundred launches.
Each floor places its models with one walk a model (`place`): a model
already on the floor's device and in eval mode, as a caller scoring floor
after floor hands it in, is used as it is, and only a model found elsewhere
or in training mode is moved and switched. `place` alone decides graph or
eager: on the card it records the storage of every parameter and buffer in
`_GRAPHS`, and a model with such an entry runs as graphs (`run_graphed`)
where it is in eval mode, its input is on the card and grad is off. The graphs are keyed by the
input's shape, dtype and device; a parameter replaced, or a state loaded
with `assign=True`, is found by the next `place`, which drops the model's
graphs, while a value changed in place is read by the next replay. Python
attributes of the model are not keyed: a replay does not call `forward`,
nor any hook. The CPU runs the verifier eagerly, as does a model `place`
has not seen on the card or one switched to training mode since.

A floor comes with its depth bank (u16 mm, as the depth cache holds it) or
with RGB alone and a HoHoNet depth model (models/hohonet.py): then the
floor's depth is computed on the card between the upload and the banks
(`depth_mm_bank`: float32, one pano a forward, each forward replayed as one
CUDA graph as the verifier's is), in the cache's millimetres,
and nothing of it is kept after the call.

Spans (utils/profiler.py; recorded only under a profiler): `floor` for the
call (its id the running count of floors scored) with `place` (the
models' placement), `upload`, `depth` (only where the floor
came without depth), `banks` and one `batch` a batch inside it; in a batch
`prepare` (the padded chunk and its index and pose tensors),
`score_batch`'s `warp`, `preprocess` and `verifier`, `fetch` (where the
host waits for the card) and `collect`.
Counters: `floors`, `hypotheses`, `panos`, `h2d_bytes` (the banks'
upload, RGB alone where the depth is computed, and each batch's tensors),
`depth/panos` (panos whose depth the call computed), `rows` and
`padded_rows` (a batch's rows, of them padding), `d2h_bytes`; in
`verifier`, one of `verifier/graph_replays` (a batch the graph scored, the
batch that captured it among them) or `verifier/eager` a batch, and
`verifier/graph_captures`; in `depth`, the same three `depth/` counters a
forward; in `place`, one of `models/resident` (found placed) or
`models/placed` (moved or switched to eval) a model.
"""

from __future__ import annotations

import itertools
import weakref
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from salve_tpu_torch.device import DeviceLike, resolve_device
from salve_tpu_torch.depth.cache import meters_to_mm
from salve_tpu_torch.models.hohonet import resize_linear_batch
from salve_tpu_torch.ops.backproject import CEILING_Z_RANGE, FLOOR_Z_RANGE
from salve_tpu_torch.ops.warp import warp_banks_auto
from salve_tpu_torch.parallel.mesh import Mesh, all_gather_rows, shard_batch
from salve_tpu_torch.rendering.bev_pair import (
    BEVRenderConfig,
    HOHO_S_ZIND_SCALE_FACTOR,
    render_identity_banks,
    render_identity_batched,
    render_transformed_batched,
)
from salve_tpu_torch.training import transforms
from salve_tpu_torch.training.config import TrainingConfig
from salve_tpu_torch.utils import profiler


class ScoredHypothesis(NamedTuple):
    """Verifier verdict for one alignment hypothesis."""

    i1: int
    i2: int
    wdo_pair_uuid: str
    configuration: str
    y_hat: int
    prob: float  # probability of the predicted class


@torch.no_grad()
def score_batch(
    model: torch.nn.Module,
    cfg: TrainingConfig,
    render_cfg: BEVRenderConfig,
    use_warp_renders: bool,
    depths: torch.Tensor,
    rgbs: torch.Tensor,
    bank_ceil: torch.Tensor,
    bank_floor: torch.Tensor,
    i1_idx: torch.Tensor,
    i2_idx: torch.Tensor,
    rotations: torch.Tensor,
    translations: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused render -> preprocess -> verify batch (JAX `_make_score_body`).

    In warp mode `depths`/`rgbs` hold the extended packed rgb888 warp banks
    of the ceiling and the floor instead of the raw pano banks. The verifier
    replays its graph where `place` put `model` on the card and it is still in
    eval mode; a caller who replaces, moves or reloads its parameters after
    that calls `place` again before the next batch.
    """
    with profiler.annotate("warp"):
        if use_warp_renders:
            t_scaled = translations * HOHO_S_ZIND_SCALE_FACTOR
            ceil1, floor1 = warp_banks_auto(
                (depths, rgbs), rotations, t_scaled, render_cfg.img_px, render_cfg.meters_per_px,
                bank_idx=i1_idx,
            )
        else:
            d1, c1 = depths[i1_idx], rgbs[i1_idx]
            ceil1 = render_transformed_batched(d1, c1, rotations, translations, CEILING_Z_RANGE, render_cfg)
            floor1 = render_transformed_batched(d1, c1, rotations, translations, FLOOR_Z_RANGE, render_cfg)
        # Pano 2 is rendered in its own frame: it comes from the identity bank.
        ceil2, floor2 = bank_ceil[i2_idx], bank_floor[i2_idx]

    with profiler.annotate("preprocess"):
        batch = torch.stack([ceil1, ceil2, floor1, floor2], dim=1)  # (B, 4, h, w, 3) u8
        batch = transforms.resize_batch(batch, cfg.resize_h, cfg.resize_w)
        batch = transforms.preprocess_eval(batch, cfg.train_h, cfg.train_w)
    with profiler.annotate("verifier"):
        return run_graphed(_verify, model, batch, "verifier")


def _verify(model: torch.nn.Module, batch: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y_hat, prob of y_hat) of a preprocessed (B, 4, h, w, 3) batch."""
    logits = model([batch[:, i].permute(0, 3, 1, 2) for i in range(4)])
    probs = torch.softmax(logits, dim=1)
    y_hat = torch.argmax(logits, dim=1)
    return y_hat, probs[torch.arange(probs.shape[0], device=probs.device), y_hat]


class _Graph(NamedTuple):
    """A captured body (`_verify`, `_depth`): its static input and outputs.
    Holds no reference to the model."""

    graph: "torch.cuda.CUDAGraph"
    inp: torch.Tensor
    out: Tuple[torch.Tensor, ...]


# model -> (the data pointer of each parameter and buffer as `place` found
# them on the card, {(body's counter name, input shape, dtype, device): _Graph}).
# Weak, so that a model's graphs and their memory pools go with it.
_GRAPHS: "weakref.WeakKeyDictionary[torch.nn.Module, Tuple[tuple, Dict[tuple, _Graph]]]" = (
    weakref.WeakKeyDictionary())


def _walk(model: torch.nn.Module) -> Tuple[bool, set, tuple]:
    """(every module in eval mode, the devices of the parameters and buffers,
    the data pointer of each parameter and buffer), in one pass over each
    module's own dicts: `parameters()` takes three times as long on
    ResNet-152."""
    evaluating, devices, pointers = True, set(), []
    for m in model.modules():
        evaluating = evaluating and not m.training
        for t in itertools.chain(m._parameters.values(), m._buffers.values()):
            if t is not None:
                devices.add(t.device)
                pointers.append(t.data_ptr())
    return evaluating, devices, tuple(pointers)


def place(model: torch.nn.Module, dev: torch.device) -> torch.nn.Module:
    """`model` on `dev` in eval mode. One walk finds whether it is there
    already (`models/resident`); then neither `.to` nor `.eval` runs, each of
    which would walk every module to change nothing (no module of the port
    overrides `train` or `_apply`, so skipping them skips no side effect).
    Otherwise it is moved and switched (`models/placed`) and walked again. An
    index-less `cuda` is the current card, as `.to` takes it, so a model on
    another card is moved.

    On the card the model's entry in `_GRAPHS` holds the storage the walk
    found, and storage other than the entry's drops its graphs: it runs as
    graphs from here on. Off the card it has no entry and runs eagerly."""
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    evaluating, devices, pointers = _walk(model)
    if evaluating and devices <= {dev}:
        profiler.count("models/resident")
    else:
        model = model.to(dev).eval()
        profiler.count("models/placed")
        pointers = _walk(model)[2]
    if dev.type != "cuda":
        _GRAPHS.pop(model, None)
    elif model not in _GRAPHS or _GRAPHS[model][0] != pointers:
        # New storage: the graphs that read the old go, with their pools.
        _GRAPHS[model] = (pointers, {})
    return model


def run_graphed(body, model: torch.nn.Module, x: torch.Tensor, name: str) -> Tuple[torch.Tensor, ...]:
    """`body(model, x)` (a tuple of tensors), replayed from the model's graph
    of `name` and x's shape, dtype and device where `place` gave the model an
    entry, it is in eval mode (the root's flag: `place` switches every
    module), x is on the card and grad is off, and captured first where there
    is none; eager otherwise. Counts `<name>/graph_replays` (the capturing
    call among them), `<name>/graph_captures` or `<name>/eager`. The outputs
    are the caller's: no later replay writes them."""
    held = _GRAPHS.get(model)
    if held is None or model.training or x.device.type != "cuda" or torch.is_grad_enabled():
        profiler.count(f"{name}/eager")
        return body(model, x)
    graphs, shape = held[1], (name, tuple(x.shape), x.dtype, x.device)
    g = graphs.get(shape)
    if g is None:
        g = graphs[shape] = _capture(body, model, x)
        profiler.count(f"{name}/graph_captures")
    else:
        g.inp.copy_(x)
    g.graph.replay()
    profiler.count(f"{name}/graph_replays")
    return tuple(t.clone() for t in g.out)


def _capture(body, model: torch.nn.Module, x: torch.Tensor) -> _Graph:
    """The graph of `body` on a static copy of `x`, after one eager run on a
    side stream that makes cuDNN's choices outside the capture. Autocast's
    cache of cast weights is off (the verifier's own bf16 block inherits
    it), so that no cast made in the capture outlives it."""
    static = x.clone()
    side = torch.cuda.Stream(x.device)
    side.wait_stream(torch.cuda.current_stream(x.device))
    with torch.autocast("cuda", enabled=False, cache_enabled=False):
        with torch.cuda.stream(side):
            body(model, static)
        torch.cuda.current_stream(x.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = body(model, static)
    return _Graph(graph, static, out)


def _depth(model: torch.nn.Module, x: torch.Tensor) -> Tuple[torch.Tensor]:
    return (model(x),)


# Panos a forward in `depth_mm_bank`. One: on the H100 (cuDNN 9.22) at
# 512x1024 in float32 a forward takes 12-17 ms a pano at batch 1 and no less
# at batch 2, while from batch 3 cuDNN's algorithm choice (heuristic and
# benchmarked alike) takes an FFT path for two of the trunk's 3x3
# convolutions (296 -> 134 and 466 -> 168 channels at 64x128): 340-370 ms
# each against 0.36 ms at batch 1, 67-240 ms a pano in all, with 43 GB of
# workspace. At one pano a forward the bank is also, bit for bit, what the
# cache's provider computes.
DEPTH_CHUNK = 1


@torch.no_grad()
def depth_mm_bank(model: torch.nn.Module, rgbs: torch.Tensor, chunk: int = DEPTH_CHUNK) -> torch.Tensor:
    """A floor's depth bank computed where its RGB lies: (P, H, W, 3) float
    RGB in [0, 1] on the HoHoNet `model`'s device -> (P, H, W) float32
    millimetres, `depth/cache.py:meters_to_mm` of the depth, as the cache's
    u16 PNGs hold them. Forwards of `chunk` panos, each replayed as one
    CUDA graph where `place` put the model on the card (`run_graphed`,
    `depth/` counters); at a model `input_hw` other than (H, W) each chunk
    is resized to it and its depth back to (H, W) by `resize_linear_batch`.
    The model runs as it is held: float32 on the card under the port's
    numerics policy (device.py: TF32 off).

    The scorer passes `DEPTH_CHUNK` for `chunk`, which is a parameter only
    because the benchmark's stand-in for this function
    (benchmark/tests/test_bench_fresh.py) passes exactly three positional
    arguments on (ROADMAP G11)."""
    hw = tuple(rgbs.shape[1:3])
    out = []
    for start in range(0, rgbs.shape[0], chunk):
        x = rgbs[start : start + chunk]
        if hw != model.input_hw:
            x = resize_linear_batch(x, model.input_hw)
        (depth,) = run_graphed(_depth, model, x, "depth")
        if hw != model.input_hw:
            depth = resize_linear_batch(depth, hw)
        out.append(meters_to_mm(depth))
    return torch.cat(out).contiguous()


@torch.no_grad()
def build_banks(
    depths: torch.Tensor, rgbs: torch.Tensor, render_cfg: BEVRenderConfig, use_warp_renders: bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The per-floor banks: (source 1, source 2, identity ceiling, identity floor).

    Identity-frame BEV renders, one per pano per surface. In warp mode the
    two sources are the extended packed rgb888 warp banks of the ceiling and
    the floor (double the target extent), each rendered with its surface's
    identity render from one cloud; in direct mode the raw depth and rgb
    banks themselves.
    """
    if use_warp_renders:
        bank_ceil, ext_ceil = render_identity_banks(depths, rgbs, CEILING_Z_RANGE, render_cfg, 2 * render_cfg.img_px)
        bank_floor, ext_floor = render_identity_banks(depths, rgbs, FLOOR_Z_RANGE, render_cfg, 2 * render_cfg.img_px)
        return ext_ceil, ext_floor, bank_ceil, bank_floor
    bank_ceil = render_identity_batched(depths, rgbs, CEILING_Z_RANGE, render_cfg)
    bank_floor = render_identity_batched(depths, rgbs, FLOOR_Z_RANGE, render_cfg)
    return depths, rgbs, bank_ceil, bank_floor


def score_floor_hypotheses(
    model: torch.nn.Module,
    cfg: TrainingConfig,
    depths: Optional[np.ndarray],
    rgbs: np.ndarray,
    pano_id_to_bank_row: Dict[int, int],
    hypotheses: List[Tuple[int, int, object]],
    batch_size: int = 32,
    render_cfg: BEVRenderConfig = BEVRenderConfig(),
    use_warp_renders: Optional[bool] = None,
    device: DeviceLike = None,
    mesh: Optional[Mesh] = None,
    depth_model: Optional[torch.nn.Module] = None,
) -> List[ScoredHypothesis]:
    """Score every (i1, i2, AlignmentHypothesis) of a floor.

    Args:
        model: the early-fusion verifier (ceiling+floor RGB modalities); it
            is moved to `device` and put in eval mode (`place`: a model
            already there is used as it is).
        depths: (P, 512, 1024) depth bank in mm, or None with a `depth_model`;
            rgbs: (P, 512, 1024, 3) in [0, 1].
        pano_id_to_bank_row: pano ID -> bank row.
        hypotheses: (i1, i2, AlignmentHypothesis) triples.
        batch_size: hypotheses per batch (global across the mesh); the last
            batch is padded with its last hypothesis.
        use_warp_renders: render pano 1 per hypothesis as a Sim(2) warp of
            an extended identity bank instead of a fresh splat. None means
            on when the device is CUDA (the production default on the
            accelerator), off on the CPU.
        device: None means the CUDA card (raises without one); "cpu" runs
            the plain versions of the kernels. With a mesh, the mesh's device.
        mesh: this rank's place on a mesh (parallel/mesh.py:make_mesh); each
            rank scores its rows of every batch. None: one device.
        depth_model: a HoHoNetDepth (models/hohonet.py) that computes the
            floor's depth from `rgbs` on `device`, where `depths` is None;
            it is moved there and put in eval mode. On a mesh every rank
            computes it.
    """
    dev = resolve_device(device) if mesh is None else mesh.device
    if mesh is not None and batch_size % mesh.size != 0:
        raise ValueError(f"batch_size {batch_size} not divisible by mesh size {mesh.size}")
    if set(cfg.modalities) != {"ceiling_rgb_texture", "floor_rgb_texture"}:
        raise ValueError("Fused inference supports the ceiling+floor RGB verifier.")
    if (depths is None) == (depth_model is None):
        raise ValueError("Give the floor's depths or a depth_model, not both or neither.")
    if not hypotheses:
        return []
    if use_warp_renders is None:
        use_warp_renders = dev.type == "cuda"
    floor_id = profiler.count("floors")
    n_panos = int(rgbs.shape[0])
    with profiler.annotate("floor", id=floor_id, panos=n_panos):
        profiler.count("hypotheses", len(hypotheses))
        with profiler.annotate("place"):
            model = place(model, dev)
            if depth_model is not None:
                depth_model = place(depth_model, dev)

        with profiler.annotate("upload"):
            # uint16 mm -> float32 is exact; float32 banks index on every device.
            if depths is not None:
                depths_d = torch.as_tensor(np.asarray(depths, dtype=np.float32), device=dev)
                profiler.count("h2d_bytes", depths_d.nbytes)
            rgbs_d = torch.as_tensor(np.asarray(rgbs, dtype=np.float32), device=dev)
            profiler.count("panos", n_panos)
            profiler.count("h2d_bytes", rgbs_d.nbytes)
        if depths is None:
            with profiler.annotate("depth", panos=n_panos):
                profiler.count("depth/panos", n_panos)
                depths_d = depth_mm_bank(depth_model, rgbs_d, DEPTH_CHUNK)
        with profiler.annotate("banks"):
            depths_d, rgbs_d, bank_ceil, bank_floor = build_banks(depths_d, rgbs_d, render_cfg, use_warp_renders)

        rows = {pano_id_to_bank_row[i] for h in hypotheses for i in h[:2]}
        if not all(0 <= r < depths_d.shape[0] for r in rows):
            raise ValueError(f"bank rows {sorted(rows)} outside a bank of {depths_d.shape[0]} panos")

        results: List[ScoredHypothesis] = []
        for start in range(0, len(hypotheses), batch_size):
            with profiler.annotate("batch"):
                chunk = hypotheses[start : start + batch_size]
                profiler.count("rows", batch_size)
                profiler.count("padded_rows", batch_size - len(chunk))
                with profiler.annotate("prepare"):
                    chunk_p = chunk + [chunk[-1]] * (batch_size - len(chunk))
                    if mesh is not None:
                        chunk_p = shard_batch(mesh, chunk_p)
                    i1_idx = torch.tensor([pano_id_to_bank_row[h[0]] for h in chunk_p], device=dev)
                    i2_idx = torch.tensor([pano_id_to_bank_row[h[1]] for h in chunk_p], device=dev)
                    rotations = torch.from_numpy(
                        np.stack([h[2].i2Ti1.rotation for h in chunk_p]).astype(np.float32)
                    ).to(dev)
                    translations = torch.from_numpy(
                        np.stack([h[2].i2Ti1.translation for h in chunk_p]).astype(np.float32)
                    ).to(dev)
                    profiler.count("h2d_bytes", i1_idx.nbytes + i2_idx.nbytes + rotations.nbytes + translations.nbytes)

                y_hat, prob = score_batch(
                    model, cfg, render_cfg, use_warp_renders, depths_d, rgbs_d,
                    bank_ceil, bank_floor, i1_idx, i2_idx, rotations, translations,
                )
                if mesh is not None:
                    y_hat, prob = all_gather_rows(mesh, y_hat), all_gather_rows(mesh, prob)
                with profiler.annotate("fetch"):
                    y_hat, prob = y_hat.cpu().numpy(), prob.cpu().numpy()
                    profiler.count("d2h_bytes", y_hat.nbytes + prob.nbytes)
                with profiler.annotate("collect"):
                    for k, (i1, i2, ah) in enumerate(chunk):
                        results.append(
                            ScoredHypothesis(
                                i1=i1,
                                i2=i2,
                                wdo_pair_uuid=f"{ah.wdo_alignment_object}_{ah.i1_wdo_idx}_{ah.i2_wdo_idx}",
                                configuration=ah.configuration,
                                y_hat=int(y_hat[k]),
                                prob=float(prob[k]),
                            )
                        )
    return results
