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
hypothesis in direct mode. On the card a floor's banks are one CUDA graph
a pano count (`build_banks`, floors of up to 8 panos), captured on the
first floor of the count and replayed on every later one, in place of
several hundred small launches.

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

A layout verifier (modalities ceiling RGB, floor RGB and layout: six
images) also takes the floor's room layouts, one (room vertices, W/D/Os) a
bank row, as the layout modality's file-contract renderer reads them
(rendering/dataset_renderer.py:_render_layout_pairs). Each floor rasterizes
pano 2's layout bank once (rendering/layout.py, on the card); each batch
moves pano 1's layout of every row into pano 2's frame on the host, in
float64 as `layout_pair_inputs` does, and draws the rows in one call, so
that the verifier sees the file-contract renderer's rasters byte for byte
(a nearest-neighbour warp of anti-aliased lines would be another image).

A floor comes with its depth bank (u16 mm, as the depth cache holds it) or
with RGB alone and a HoHoNet depth model (models/hohonet.py): then the
floor's depth is computed on the card between the upload and the banks
(`depth_mm_bank`: float32, one pano a forward, each forward replayed as one
CUDA graph as the verifier's is), in the cache's millimetres,
and nothing of it is kept after the call.

Spans (utils/profiler.py; recorded only under a profiler): `floor` for the
call (its id the running count of floors scored) with `place` (the
models' placement), `upload`, `depth` (only where the floor
came without depth), `banks`, `layout` (a layout verifier's floor: pano
2's layout bank) and one `batch` a batch inside it; in a batch `prepare`
(the padded chunk and its index and pose tensors), `layout` (a layout
verifier's: pano 1's rasters of the batch's rows), `score_batch`'s `warp`,
`preprocess` and `verifier`, `fetch` (where the host waits for the card)
and `collect`.
Counters: `floors`, `hypotheses`, `panos`, `h2d_bytes` (the banks'
upload, RGB alone where the depth is computed, each batch's tensors and
the layouts' vertices, segments and colours),
`layout/rasters`, `layout/vertices` and `layout/wdos` (rasters drawn, and
the real room vertices and W/D/Os in them),
`depth/panos` (panos whose depth the call computed), `rows` and
`padded_rows` (a batch's rows, of them padding), `d2h_bytes`; in
`verifier`, one of `verifier/graph_replays` (a batch the graph scored, the
batch that captured it among them) or `verifier/eager` a batch, and
`verifier/graph_captures`; in `depth`, the same three `depth/` counters a
forward; in `banks`, the same three `banks/` counters a floor; in `place`,
one of `models/resident` (found placed) or `models/placed` (moved or
switched to eval) a model.
"""

from __future__ import annotations

import functools
import itertools
import weakref
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from salve_tpu_torch.device import DeviceLike, resolve_device
from salve_tpu_torch.depth.cache import meters_to_mm
from salve_tpu_torch.models.hohonet import resize_linear_batch
from salve_tpu_torch.ops.backproject import CEILING_Z_RANGE, FLOOR_Z_RANGE
from salve_tpu_torch.ops.warp import warp_banks_auto
from salve_tpu_torch.parallel.mesh import Mesh, all_gather_rows, shard_batch
from salve_tpu_torch.rendering import layout as layout_render
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
    layout1: Optional[torch.Tensor] = None,
    bank_layout: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused render -> preprocess -> verify batch (JAX `_make_score_body`).

    In warp mode `depths`/`rgbs` hold the extended packed rgb888 warp banks
    of the ceiling and the floor instead of the raw pano banks. A layout
    verifier also takes the rows' pano 1 layout rasters (`layout1`) and the
    floor's layout bank, and sees its six images in training's order
    (dataset/bev_pairs.py): ceiling 1, ceiling 2, floor 1, floor 2, layout
    1, layout 2. The verifier
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
        images = [ceil1, bank_ceil[i2_idx], floor1, bank_floor[i2_idx]]
        if layout1 is not None:
            images += [layout1, bank_layout[i2_idx]]

    with profiler.annotate("preprocess"):
        batch = torch.stack(images, dim=1)  # (B, 4 or 6, h, w, 3) u8
        batch = transforms.resize_batch(batch, cfg.resize_h, cfg.resize_w)
        batch = transforms.preprocess_eval(batch, cfg.train_h, cfg.train_w)
    with profiler.annotate("verifier"):
        return run_graphed(_verify, model, batch, "verifier")


def _verify(model: torch.nn.Module, batch: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y_hat, prob of y_hat) of a preprocessed (B, model.n_images, h, w, 3) batch."""
    logits = model([batch[:, i].permute(0, 3, 1, 2) for i in range(model.n_images)])
    probs = torch.softmax(logits, dim=1)
    y_hat = torch.argmax(logits, dim=1)
    return y_hat, probs[torch.arange(probs.shape[0], device=probs.device), y_hat]


class _Graph(NamedTuple):
    """A captured body (`_verify`, `_depth`, `_banks`): its static inputs
    and outputs. Holds no reference to a model."""

    graph: "torch.cuda.CUDAGraph"
    inp: Tuple[torch.Tensor, ...]
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
    return _replay(held[1], (name, tuple(x.shape), x.dtype, x.device), functools.partial(body, model), (x,), name)


def _replay(graphs: Dict[tuple, _Graph], key: tuple, body, xs: Tuple[torch.Tensor, ...], name: str,
            pool=None) -> Tuple[torch.Tensor, ...]:
    """`body(*xs)` replayed from `graphs[key]`, captured there first (into
    `pool`, a private one where None) where there is none. Counts
    `<name>/graph_replays` (the capturing call among them) and
    `<name>/graph_captures`; the hand-written kernels count their launches
    in the eager run and the capture alone (device.py). The outputs are
    clones: no later replay writes them."""
    g = graphs.get(key)
    if g is None:
        g = graphs[key] = _capture(body, xs, pool)
        profiler.count(f"{name}/graph_captures")
    else:
        for static, x in zip(g.inp, xs):
            static.copy_(x)
    g.graph.replay()
    profiler.count(f"{name}/graph_replays")
    return tuple(t.clone() for t in g.out)


def _capture(body, xs: Tuple[torch.Tensor, ...], pool=None) -> _Graph:
    """The graph of `body` on static copies of `xs`, after one eager run on a
    side stream that makes cuDNN's choices outside the capture. Autocast's
    cache of cast weights is off (the verifier's own bf16 block inherits
    it), so that no cast made in the capture outlives it."""
    static = tuple(x.clone() for x in xs)
    dev = static[0].device
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.autocast("cuda", enabled=False, cache_enabled=False):
        with torch.cuda.stream(side):
            body(*static)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool):
            out = body(*static)
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


# device -> (the one memory pool of its banks' graphs, {(the banks' shapes and
# dtypes, the render config, the mode): the graph of `_banks`}), a graph a
# pano count kept for the process. The graphs replay one at a time on one
# stream, and each replay's outputs are cloned before the next, so one
# graph's scratch may lie where another's lay; static inputs lie outside the
# pool.
_BANK_GRAPHS: Dict[torch.device, Tuple[tuple, Dict[tuple, _Graph]]] = {}

# The most panos a floor whose banks run as a graph may hold. The host takes
# about 11-13 ms to launch a floor's banks eagerly and the card about 0.93 ms
# a pano to run them, so past 8 panos the card's own work hides most of the
# launching and a graph saves little a floor; each pano count it captures
# costs 0.1-0.8 s once, about 18 MB a pano of static inputs and outputs, and
# its scratch in the pool, for the process. So at most 8 graphs a render
# config and mode, and 0.64 GB of static tensors, stay on a card.
GRAPHED_MAX_PANOS = 8


def _banks(depths: torch.Tensor, rgbs: torch.Tensor, render_cfg: BEVRenderConfig,
           use_warp_renders: bool) -> Tuple[torch.Tensor, ...]:
    """The banks `build_banks` renders: (source 1, source 2, identity
    ceiling, identity floor) in warp mode, the two identity banks in direct
    mode."""
    if use_warp_renders:
        bank_ceil, ext_ceil = render_identity_banks(depths, rgbs, CEILING_Z_RANGE, render_cfg, 2 * render_cfg.img_px)
        bank_floor, ext_floor = render_identity_banks(depths, rgbs, FLOOR_Z_RANGE, render_cfg, 2 * render_cfg.img_px)
        return ext_ceil, ext_floor, bank_ceil, bank_floor
    return (render_identity_batched(depths, rgbs, CEILING_Z_RANGE, render_cfg),
            render_identity_batched(depths, rgbs, FLOOR_Z_RANGE, render_cfg))


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

    On the card the renders run as one CUDA graph a key of the banks'
    shapes, dtypes and device, the render config and the mode: captured on
    the first floor of a key, replayed on every later one (one copy in, one
    launch, the banks cloned out), all in one memory pool a card, for
    floors of up to `GRAPHED_MAX_PANOS` panos. Larger floors and the CPU
    render eagerly. Counts `banks/graph_replays` (the capturing floor among
    them) and `banks/graph_captures`, or `banks/eager`.
    """
    body = functools.partial(_banks, render_cfg=render_cfg, use_warp_renders=use_warp_renders)
    if depths.device.type == "cuda" and depths.shape[0] <= GRAPHED_MAX_PANOS:
        held = _BANK_GRAPHS.get(depths.device)
        if held is None:
            held = _BANK_GRAPHS[depths.device] = (torch.cuda.graph_pool_handle(), {})
        key = (tuple(depths.shape), depths.dtype, tuple(rgbs.shape), rgbs.dtype, render_cfg, use_warp_renders)
        banks = _replay(held[1], key, body, (depths, rgbs), "banks", held[0])
    else:
        profiler.count("banks/eager")
        banks = body(depths, rgbs)
    return banks if use_warp_renders else (depths, rgbs, *banks)


RGB_MODALITIES = frozenset({"ceiling_rgb_texture", "floor_rgb_texture"})
LAYOUT_MODALITIES = RGB_MODALITIES | {"layout"}


class FloorLayouts(NamedTuple):
    """A floor's layouts as the scorer draws them: per bank row the room
    vertices followed by each W/D/O's two endpoints, float64 in the pano's
    own frame, so that one transform a row moves them all; and the padded
    W/D/O colours, in paint order."""

    points: List[np.ndarray]  # per row (n_verts + 2 n_wdos, 2) float64
    n_verts: np.ndarray  # (P,) int64
    n_wdos: np.ndarray  # (P,) int64
    colors: np.ndarray  # (P, max W/D/Os, 3) float32

    @classmethod
    def of(cls, layouts: Sequence[Tuple[np.ndarray, list]]) -> "FloorLayouts":
        """From one (room_vertices_local_2d, wdos) a bank row, as
        rendering/layout.py:rasterize_layout_batch takes them."""
        n_verts = np.array([len(v) for v, _ in layouts], dtype=np.int64)
        n_wdos = np.array([len(w) for _, w in layouts], dtype=np.int64)
        colors = np.zeros((len(layouts), max(int(n_wdos.max()), 1), 3), dtype=np.float32)
        points = []
        for r, (verts, wdos) in enumerate(layouts):
            points.append(np.concatenate([np.asarray(verts, dtype=np.float64).reshape(-1, 2)]
                                         + [w.vertices_local_2d for w in wdos]))
            for k, w in enumerate(wdos):
                colors[r, k] = layout_render.WDO_COLORS[w.type]
        return cls(points, n_verts, n_wdos, colors)

    def padded(self, rows: Sequence[int], moves: Optional[Sequence] = None) -> Tuple[np.ndarray, ...]:
        """`layout_rasters`'s host arrays of the bank rows `rows`, each moved
        by its Sim(2) of `moves` where given (pano 1 into pano 2's frame:
        `Sim2.transform_from` in float64, as rendering/layout.py:
        layout_pair_inputs moves the room and each W/D/O), then cast to
        float32 as its `_pad_layout` casts them. Padded to the floor's
        largest layout: the rasters do not depend on the padding."""
        rows = np.asarray(rows, dtype=np.int64)
        n_v, n_w = self.n_verts[rows], self.n_wdos[rows]
        verts = np.zeros((len(rows), max(int(self.n_verts.max()), 1), 2), dtype=np.float32)
        segs = np.zeros((len(rows), self.colors.shape[1], 2, 2), dtype=np.float32)
        for k, r in enumerate(rows):
            pts = self.points[r] if moves is None else moves[k].transform_from(self.points[r])
            verts[k, : n_v[k]] = pts[: n_v[k]]
            segs[k, : n_w[k]] = pts[n_v[k]:].reshape(-1, 2, 2)
        return verts, n_v, segs, self.colors[rows], n_w


def layout_rasters(verts: np.ndarray, n_verts: np.ndarray, segs: np.ndarray, colors: np.ndarray,
                   n_wdos: np.ndarray, render_cfg: BEVRenderConfig, dev: torch.device) -> torch.Tensor:
    """(N, img_px + 1, img_px + 1, 3) u8 layout rasters on `dev` of N padded
    host layouts (`FloorLayouts.padded`): the vertices, segments and colours
    go up in one copy, the counts stay on the host, and all N are drawn in
    one `rendering/layout.py:rasterize_layout_batch_device` call at the
    render config's size and scale. Counts `layout/rasters`,
    `layout/vertices`, `layout/wdos` and `h2d_bytes`."""
    n, v, k = verts.shape[0], verts.shape[1], segs.shape[1]
    packed = torch.as_tensor(np.concatenate([verts.reshape(n, -1), segs.reshape(n, -1), colors.reshape(n, -1)],
                                            axis=1), device=dev)
    profiler.count("h2d_bytes", packed.nbytes)
    profiler.count("layout/rasters", n)
    profiler.count("layout/vertices", int(n_verts.sum()))
    profiler.count("layout/wdos", int(n_wdos.sum()))
    verts_d, segs_d, colors_d = packed.split([2 * v, 4 * k, 3 * k], dim=1)
    return layout_render.rasterize_layout_batch_device(
        verts_d.unflatten(1, (v, 2)), torch.from_numpy(n_verts), segs_d.unflatten(1, (k, 2, 2)),
        colors_d.unflatten(1, (k, 3)), torch.from_numpy(n_wdos), render_cfg.img_px, render_cfg.meters_per_px)


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
    layouts: Optional[Sequence[Tuple[np.ndarray, list]]] = None,
) -> List[ScoredHypothesis]:
    """Score every (i1, i2, AlignmentHypothesis) of a floor.

    Args:
        model: the early-fusion verifier (ceiling+floor RGB modalities, with
            or without the layout); it is moved to `device` and put in eval
            mode (`place`: a model already there is used as it is).
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
        layouts: a layout verifier's floor layouts, one (room vertices
            (V, 2), W/D/Os) a bank row in the pano's frame, as
            rendering/layout.py:rasterize_layout_batch takes them (the W/D/Os
            in paint order, `PanoData.all_wdos`); required with the layout
            modality, refused without it. On a mesh each rank draws its rows.
    """
    dev = resolve_device(device) if mesh is None else mesh.device
    if mesh is not None and batch_size % mesh.size != 0:
        raise ValueError(f"batch_size {batch_size} not divisible by mesh size {mesh.size}")
    if set(cfg.modalities) not in (RGB_MODALITIES, LAYOUT_MODALITIES):
        raise ValueError("Fused inference supports the ceiling+floor RGB verifier, with or without the layout.")
    if ("layout" in cfg.modalities) != (layouts is not None):
        raise ValueError("A layout verifier takes the floor's layouts, one a bank row; an RGB verifier takes none.")
    if layouts is not None and len(layouts) != rgbs.shape[0]:
        raise ValueError(f"{len(layouts)} layouts for a bank of {rgbs.shape[0]} panos")
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
        bank_layout = None
        if layouts is not None:
            with profiler.annotate("layout"):
                floor_layouts = FloorLayouts.of(layouts)
                bank_layout = layout_rasters(*floor_layouts.padded(range(n_panos)), render_cfg, dev)

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
                layout1 = None
                if layouts is not None:
                    with profiler.annotate("layout"):
                        padded = floor_layouts.padded([pano_id_to_bank_row[h[0]] for h in chunk_p],
                                                      [h[2].i2Ti1 for h in chunk_p])
                        layout1 = layout_rasters(*padded, render_cfg, dev)

                y_hat, prob = score_batch(
                    model, cfg, render_cfg, use_warp_renders, depths_d, rgbs_d,
                    bank_ceil, bank_floor, i1_idx, i2_idx, rotations, translations, layout1, bank_layout,
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
