"""Fused Stage B+C inference: render and verify hypotheses on the card.

Port of salve_tpu/pipeline/fused_inference.py. For each hypothesis batch:
render ceiling+floor texture-map pairs from the device-resident pano bank,
quantize to u8 (the domain the verifier was trained on), resize to the eval
resolution and score with the early-fusion CNN, with no image files and no
host round trip of images. Output is the per-hypothesis (y_hat, prob)
record Stage D consumes.

Kernels on this path: B1 (splat) and B2 (fill + mask) for the identity and
warp banks, and in warp mode B3 (shear warp), one launch a batch for the
ceiling and the floor; B1 and B2 per hypothesis in direct mode.

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
It engages from what the code can observe, with no switch: the model's
parameters on the card, every module in eval mode, grad off. The graph is
keyed by the batch's shape, dtype and device and by the storage of every
parameter and buffer (`verifier_key`, computed once a floor): a parameter
replaced, or a state loaded with `assign=True`, captures anew, while a
value changed in place is read by the next replay. Python attributes of the
model are not keyed: a replay does not call `forward`, nor any hook. The
CPU, and a model in training mode, run the verifier eagerly.

Spans (utils/profiler.py; recorded only under a profiler): `floor` for the
call (its id the running count of floors scored) with `upload`, `banks` and
one `batch` a batch inside it; in a batch `prepare` (the padded chunk and
its index and pose tensors), `score_batch`'s `warp`, `preprocess` and
`verifier`, `fetch` (where the host waits for the card) and `collect`.
Counters: `floors`, `hypotheses`, `panos`, `h2d_bytes` (the banks'
upload and each batch's tensors), `rows` and `padded_rows` (a batch's
rows, of them padding), `d2h_bytes`; in `verifier`, one of
`verifier/graph_replays` (a batch the graph scored, the batch that captured
it among them) or `verifier/eager` a batch, and `verifier/graph_captures`.
"""

from __future__ import annotations

import itertools
import weakref
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from salve_tpu_torch.device import DeviceLike, resolve_device
from salve_tpu_torch.ops.backproject import CEILING_Z_RANGE, FLOOR_Z_RANGE
from salve_tpu_torch.parallel.mesh import Mesh, all_gather_rows, shard_batch
from salve_tpu_torch.rendering.bev_pair import (
    BEVRenderConfig,
    HOHO_S_ZIND_SCALE_FACTOR,
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
    key: Optional[tuple] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused render -> preprocess -> verify batch (JAX `_make_score_body`).

    In warp mode `depths`/`rgbs` hold the extended packed rgb888 warp banks
    of the ceiling and the floor instead of the raw pano banks. `key` is
    `verifier_key(model)`, which a caller scoring many batches computes
    once; None computes it here.
    """
    with profiler.annotate("warp"):
        if use_warp_renders:
            from salve_tpu_torch.ops.warp import warp_banks_auto

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
        return run_verifier(model, batch, verifier_key(model) if key is None else key)


def _verify(model: torch.nn.Module, batch: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y_hat, prob of y_hat) of a preprocessed (B, 4, h, w, 3) batch."""
    logits = model([batch[:, i].permute(0, 3, 1, 2) for i in range(4)])
    probs = torch.softmax(logits, dim=1)
    y_hat = torch.argmax(logits, dim=1)
    return y_hat, probs[torch.arange(probs.shape[0], device=probs.device), y_hat]


class _Graph(NamedTuple):
    """A captured `_verify`: its static input and outputs. Holds no
    reference to the model."""

    graph: "torch.cuda.CUDAGraph"
    batch: torch.Tensor
    y_hat: torch.Tensor
    prob: torch.Tensor


# model -> (its parameter key, {batch key: _Graph}). Weak, so that a model's
# graphs and their memory pools go with it.
_GRAPHS: "weakref.WeakKeyDictionary[torch.nn.Module, Tuple[tuple, Dict[tuple, _Graph]]]" = (
    weakref.WeakKeyDictionary())


def _walk(model: torch.nn.Module) -> Tuple[bool, tuple]:
    """(every module in eval mode and every parameter and buffer on the
    card, the data pointer of each parameter and buffer), in one pass over
    each module's own dicts: `parameters()` takes three times as long on
    ResNet-152."""
    graphable, pointers = True, []
    for m in model.modules():
        graphable = graphable and not m.training
        for t in itertools.chain(m._parameters.values(), m._buffers.values()):
            if t is not None:
                graphable = graphable and t.is_cuda
                pointers.append(t.data_ptr())
    return graphable, tuple(pointers)


def parameter_key(model: torch.nn.Module) -> tuple:
    """The storage a captured verifier reads besides its input: the data
    pointer of every parameter and buffer of `model`."""
    return _walk(model)[1]


def batch_key(batch: torch.Tensor) -> tuple:
    return tuple(batch.shape), batch.dtype, batch.device


def verifier_key(model: torch.nn.Module) -> tuple:
    """`parameter_key(model)` where the verifier can run as a CUDA graph:
    every module in eval mode and every parameter and buffer on the card;
    else () and the verifier runs eagerly."""
    graphable, key = _walk(model)
    return key if graphable else ()


def run_verifier(model: torch.nn.Module, batch: torch.Tensor, key: tuple) -> Tuple[torch.Tensor, torch.Tensor]:
    """`_verify(model, batch)`, replayed from the graph of (`key`, the
    batch's key) where `key` is not () (`verifier_key`), the batch is on the
    card and grad is off, and captured first where there is none; eager
    otherwise. The outputs are the caller's: no later replay writes them."""
    if not key or batch.device.type != "cuda" or torch.is_grad_enabled():
        profiler.count("verifier/eager")
        return _verify(model, batch)
    held = _GRAPHS.get(model)
    if held is None or held[0] != key:
        # New storage: the graphs that read the old go, with their pools.
        held = _GRAPHS[model] = (key, {})
    graphs, shape = held[1], batch_key(batch)
    g = graphs.get(shape)
    if g is None:
        g = graphs[shape] = _capture(model, batch)
        profiler.count("verifier/graph_captures")
    else:
        g.batch.copy_(batch)
    g.graph.replay()
    profiler.count("verifier/graph_replays")
    return g.y_hat.clone(), g.prob.clone()


def _capture(model: torch.nn.Module, batch: torch.Tensor) -> _Graph:
    """The graph of `_verify` on a static copy of `batch`, after one eager
    run on a side stream that makes cuDNN's choices outside the capture.
    Autocast's cache of cast weights is off (the model's own bf16 block
    inherits it), so that no cast made in the capture outlives it."""
    static = batch.clone()
    side = torch.cuda.Stream(batch.device)
    side.wait_stream(torch.cuda.current_stream(batch.device))
    with torch.autocast("cuda", enabled=False, cache_enabled=False):
        with torch.cuda.stream(side):
            _verify(model, static)
        torch.cuda.current_stream(batch.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y_hat, prob = _verify(model, static)
    return _Graph(graph, static, y_hat, prob)


@torch.no_grad()
def build_banks(
    depths: torch.Tensor, rgbs: torch.Tensor, render_cfg: BEVRenderConfig, use_warp_renders: bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The per-floor banks: (source 1, source 2, identity ceiling, identity floor).

    Identity-frame BEV renders, one per pano per surface. In warp mode the
    two sources are the extended packed rgb888 warp banks of the ceiling and
    the floor (double the target extent); in direct mode the raw depth and
    rgb banks themselves.
    """
    bank_ceil = render_identity_batched(depths, rgbs, CEILING_Z_RANGE, render_cfg)
    bank_floor = render_identity_batched(depths, rgbs, FLOOR_Z_RANGE, render_cfg)
    if not use_warp_renders:
        return depths, rgbs, bank_ceil, bank_floor
    from salve_tpu_torch.ops.warp import pack_rgb888, render_identity_bank_extended

    bank_px = 2 * render_cfg.img_px
    ext_ceil = pack_rgb888(render_identity_bank_extended(depths, rgbs, CEILING_Z_RANGE, render_cfg, bank_px))
    ext_floor = pack_rgb888(render_identity_bank_extended(depths, rgbs, FLOOR_Z_RANGE, render_cfg, bank_px))
    return ext_ceil, ext_floor, bank_ceil, bank_floor


def score_floor_hypotheses(
    model: torch.nn.Module,
    cfg: TrainingConfig,
    depths: np.ndarray,
    rgbs: np.ndarray,
    pano_id_to_bank_row: Dict[int, int],
    hypotheses: List[Tuple[int, int, object]],
    batch_size: int = 32,
    render_cfg: BEVRenderConfig = BEVRenderConfig(),
    use_warp_renders: Optional[bool] = None,
    device: DeviceLike = None,
    mesh: Optional[Mesh] = None,
) -> List[ScoredHypothesis]:
    """Score every (i1, i2, AlignmentHypothesis) of a floor.

    Args:
        model: the early-fusion verifier (ceiling+floor RGB modalities); it
            is moved to `device` and put in eval mode.
        depths: (P, 512, 1024) depth bank in mm; rgbs: (P, 512, 1024, 3) in [0, 1].
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
    """
    dev = resolve_device(device) if mesh is None else mesh.device
    if mesh is not None and batch_size % mesh.size != 0:
        raise ValueError(f"batch_size {batch_size} not divisible by mesh size {mesh.size}")
    if set(cfg.modalities) != {"ceiling_rgb_texture", "floor_rgb_texture"}:
        raise ValueError("Fused inference supports the ceiling+floor RGB verifier.")
    if not hypotheses:
        return []
    if use_warp_renders is None:
        use_warp_renders = dev.type == "cuda"
    floor_id = profiler.count("floors")
    with profiler.annotate("floor", id=floor_id, panos=int(depths.shape[0])):
        profiler.count("hypotheses", len(hypotheses))
        model = model.to(dev).eval()
        key = verifier_key(model)

        with profiler.annotate("upload"):
            # uint16 mm -> float32 is exact; float32 banks index on every device.
            depths_d = torch.as_tensor(np.asarray(depths, dtype=np.float32), device=dev)
            rgbs_d = torch.as_tensor(np.asarray(rgbs, dtype=np.float32), device=dev)
            profiler.count("panos", depths_d.shape[0])
            profiler.count("h2d_bytes", depths_d.nbytes + rgbs_d.nbytes)
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
                    bank_ceil, bank_floor, i1_idx, i2_idx, rotations, translations, key=key,
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
