"""Driver `horizon_scoring`: freshly captured floors scored by the layout
verifier, each pano's layout computed by HorizonNet inside the port's scorer.

The program under test is `salve_tpu_torch.pipeline.fused_inference.
score_floor_hypotheses` as the `layout_scoring` driver calls it, on the same
floors (depth handed in as u16 mm), with the same six-image verifier, but
handed no rooms: a HorizonNet `layout_model` (the port's `HorizonNet`, its
weights drawn from the seed on the card and loaded with
`load_state_dict(strict=True)`, as a released checkpoint is) and each pano's
W/D/O spans (`span_pool`: 0-3 of each type, an opening split by the seam
in 30% of the panos, merged as MHNet's parser merges it). The scorer
computes every pano's floor boundary on the card in float32, turns each
into the pano's room and W/D/Os on the host, and draws the layouts from
them; nothing is cached across calls.

The weights' output layer is scaled by one scalar (`boundary_scale`) so
that the float32 reference's floor boundaries of the warm-up floor reach
SPREAD_ROWS rows from the published bias's row (about 325 of 512) and no
further, as the seeded MHNet law spreads them (layouts.py: 330 +- 40). The
verifier's head is scaled as the layout driver scales it, on the
reference's layouts of that floor.

One client, closed loop, whole floors until `seconds` have passed; the
traced run scores the mix's first `trace_floors` floors untraced and then
under the profiler, with `fused_scoring`'s `bench/` ranges and a
`bench/horizon` range around each boundary call (`floor_boundary_bank`).

`correct` compares what the timed path itself produced with the plain
float32 references (reference/horizonnet.py, reference/layout.py,
reference/score_layout.py): the window keeps the boundaries and layout
rasters of `reference_floors` floors, a sample drawn from the seed as the
floors complete, and after the window
* `boundary_gap_px`: the largest |difference| between the program's float32
  boundary rows, before any rounding, and the reference's, over every
  column of every kept pano;
* `layout_gap`: as in `layout_scoring`, against the rasters of the rooms the
  benchmark's own copy of the parser (`reference_layout`: layouts.py's
  `pixel_to_floor` and `rdp`) makes of the reference's boundaries;
* `logit_gap`: as in `layout_scoring`, the reference chain fed those rasters.
"""

from __future__ import annotations

import gc
import inspect
import math
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from benchmark import layouts, synthetic, traffic
from benchmark.drivers import fused_scoring as fs
from benchmark.drivers import layout_scoring as ls
from benchmark.drivers.fresh_scoring import Reservoir
from benchmark.horizonnet_weights import LINEAR_BIAS, make_state_dict as horizon_state, scale_output
from benchmark.reference import horizonnet as ref_horizon
from benchmark.reference import layout as ref_layout
from benchmark.reference import score_layout as ref_score
from benchmark.tracing import Spans, profile
from benchmark.weights import arch_of, make_state_dict

# The configuration's HorizonNet keys and the published model's values,
# which the program's model and the reference hold as constants.
PLAN = {"horizonnet_backbone": "resnet50", "horizonnet_rnn_layers": ref_horizon.LAYERS,
        "horizonnet_rnn_hidden": ref_horizon.HIDDEN, "horizonnet_bidirectional": True,
        "horizonnet_step_cols": ref_horizon.STEP_COLS, "horizonnet_out_scale": ref_horizon.OUT_SCALE,
        "horizonnet_dtype": "float32"}
# The largest distance, in rows of a 512-row pano, of the warm-up floor's
# reference boundaries from the output bias's row.
SPREAD_ROWS = 40.0
# Spans are drawn from this stream of the seed.
SPAN_STREAM = 42


def _check(config: Dict, mix: Dict) -> Tuple[int, int]:
    from salve_tpu_torch.pipeline import fused_inference

    if "layout_model" not in inspect.signature(fused_inference.score_floor_hypotheses).parameters:
        raise SystemExit("horizon_scoring: this program's score_floor_hypotheses takes no layout_model, so it "
                         "cannot compute a floor's layouts")
    bad = {k: config.get(k) for k, v in PLAN.items() if config.get(k) != v}
    if bad or list(config["horizonnet_input_hw"]) != list(mix["pano_hw"]):
        raise ValueError(f"horizon_scoring runs HorizonNet at its published plan on panos at its input size; got "
                         f"{bad}, input {config['horizonnet_input_hw']} for panos {mix['pano_hw']}")
    if "layout" not in config["modalities"] or config["n_images"] != 6:
        raise ValueError(f"horizon_scoring runs the six-image layout verifier; got {config['modalities']}")
    return tuple(config["horizonnet_input_hw"])


def span_pool(num_panos: int, seed: int) -> List[Dict[str, List[Tuple[float, float]]]]:
    """Each pool pano's W/D/O spans by type ("doors", "windows", "openings"),
    by layouts.py's law: 0-3 of each type, each starting uniform in [0.02,
    0.9] of the width and 0.02-0.08 wide, and in 30% of the panos an opening
    split by the seam, merged into one span put last (layouts.merge_seam)."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), SPAN_STREAM]))
    pool = []
    for _ in range(num_panos):
        spans = {}
        for kind in layouts.KINDS:
            spans[kind] = []
            for _ in range(rng.integers(0, 4)):
                s = rng.uniform(0.02, 0.9)
                spans[kind].append((s, s + rng.uniform(0.02, 0.08)))
        if rng.uniform() < 0.3:
            spans["opening"] += [(0.001, 0.04), (0.96, 1.0)]
        pool.append({t: [(float(s), float(e)) for s, e in layouts.merge_seam(spans[kind])]
                     for kind, t in layouts.KINDS.items()})
    return pool


def reference_layout(rows: np.ndarray, spans: Dict, hw: Tuple[int, int]) -> layouts.Layout:
    """The benchmark's copy of MHNet's parser on one boundary (w float32
    rows of an (h, w) pano): the rows rounded, each column and row scaled
    to the 1024-wide pano of `layouts.pixel_to_floor` (by 1 at 512x1024),
    backprojected and RDP-simplified; each span's ends at the unrounded
    rows of its ends; the W/D/Os in paint order."""
    h, w = hw
    sx, sy = (layouts.WIDTH - 1) / (w - 1), (layouts.WIDTH / 2 - 1) / (h - 1)
    rows = np.asarray(rows, dtype=np.float32)
    px = np.stack([np.arange(w) * sx, np.round(rows).astype(np.float64) * sy], axis=-1)
    room = layouts.rdp(layouts.pixel_to_floor(px), layouts.RDP_EPSILON)
    wdos = []
    for t in layouts.PAINT_ORDER:
        for s, e in spans[t]:
            s_u, e_u = float(np.clip(s * w, 0, w - 1)), float(np.clip(e * w, 0, w - 1))
            ends = layouts.pixel_to_floor(np.array([[s_u * sx, float(rows[round(s_u)]) * sy],
                                                    [e_u * sx, float(rows[round(e_u)]) * sy]]))
            wdos.append((t, (ends[0, 0], ends[0, 1]), (ends[1, 0], ends[1, 1])))
    return layouts.Layout(room, wdos)


class ReferenceBoundaries:
    """The reference's boundary rows of pool panos, each computed once."""

    def __init__(self, state, rgbs: np.ndarray, dev, precision: str = "fp32", fault: Optional[str] = None) -> None:
        self.state, self.rgbs, self.dev, self.precision, self.fault = state, rgbs, dev, precision, fault
        self.rows: Dict[int, np.ndarray] = {}

    def __call__(self, idx) -> np.ndarray:
        """(len(idx), w) float32 rows of the pool panos `idx`."""
        need = [i for i in idx if i not in self.rows]
        if need:
            got = ref_horizon.boundary_rows(self.state, torch.as_tensor(self.rgbs[need], device=self.dev),
                                            self.precision, self.fault, block=3).cpu().numpy()
            self.rows.update(zip(need, got))
        return np.stack([self.rows[i] for i in idx])


def boundary_scale(config: Dict, mix: Dict, seed: int, rgbs: np.ndarray, dev) -> float:
    """The output layer's scale at which the warm-up floor's reference
    boundaries lie at most SPREAD_ROWS (of 512 rows) from the bias's row,
    the farthest at that distance: a boundary's distance from the bias's
    row is linear in the scale."""
    hw = tuple(config["horizonnet_input_hw"])
    warm = traffic.warmup_floor(mix, seed, config["batch_size"])
    rows = ReferenceBoundaries(horizon_state(seed, dev, hw), rgbs, dev)(
        list(range(warm.offset, warm.offset + warm.n_panos))).astype(np.float64)
    bias_row = (LINEAR_BIAS[2] / math.pi + 0.5) * hw[0] - 0.5
    return SPREAD_ROWS * hw[0] / 512 / max(float(np.abs(rows - bias_row).max()), 1e-6)


def reference_state(config: Dict, seed: int, scale: float, dev):
    return scale_output(horizon_state(seed, dev, tuple(config["horizonnet_input_hw"])), scale)


def head_scale(config: Dict, mix: Dict, seed: int, depths, rgbs, spans, boundaries: ReferenceBoundaries,
               dev) -> float:
    """`layout_scoring.head_scale` on the reference's layouts of the warm-up floor."""
    hw = tuple(config["horizonnet_input_hw"])
    warm = traffic.warmup_floor(mix, seed, config["batch_size"])
    idx = list(range(warm.offset, warm.offset + warm.n_panos))
    pool: List[Optional[layouts.Layout]] = [None] * len(spans)
    for i, rows in zip(idx, boundaries(idx)):
        pool[i] = reference_layout(rows, spans[i], hw)
    return ls.head_scale(config, mix, seed, depths, rgbs, pool, dev)


def _horizon_program(config: Dict, state, dev):
    from salve_tpu_torch.models.horizonnet import HorizonNet

    model = HorizonNet(tuple(config["horizonnet_input_hw"]))
    model.load_state_dict(state, strict=True)
    return model.to(dev).eval()


def warmup_floors(mix: Dict, seed: int, n_hypotheses: int) -> List[traffic.Floor]:
    """One floor of each size the mix draws, the largest first, each with
    its first `n_hypotheses` hypotheses: every pano count's banks graph and
    boundary forwards are captured before the window."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 23]))
    lo, hi = mix["panos_per_floor"]
    out = []
    for p in range(hi, lo - 1, -1):
        f = traffic.make_floor(mix, p, rng)
        out.append(f._replace(pairs=f.pairs[:n_hypotheses], theta_deg=f.theta_deg[:n_hypotheses],
                              t=f.t[:n_hypotheses]))
    return out


def run(config: Dict, mix: Dict, seed: int, seconds: float, trace: bool, device, t_start: float) -> Dict:
    from salve_tpu_torch.device import resolve_device
    from salve_tpu_torch.pipeline import fused_inference
    from salve_tpu_torch.utils import profiler

    hw = _check(config, mix)
    dev = resolve_device(device)
    h, w = mix["pano_hw"]
    depths, rgbs = synthetic.pano_pool(mix["pool_panos"], h, w, seed)
    spans = span_pool(mix["pool_panos"], seed)
    b_scale = boundary_scale(config, mix, seed, rgbs, dev)
    boundaries = ReferenceBoundaries(reference_state(config, seed, b_scale, dev), rgbs, dev)
    scale = head_scale(config, mix, seed, depths, rgbs, spans, boundaries, dev)
    del boundaries
    state = make_state_dict(arch_of(config), seed, dev)
    state["fc.weight"].mul_(scale)
    cfg, model, render_cfg = fs._program(config, state, dev)
    del state
    horizon = _horizon_program(config, reference_state(config, seed, b_scale, dev), dev)
    floors = traffic.floors(mix, seed)
    floor_hyps = [fs.hypotheses(f) for f in floors]
    kw = dict(batch_size=config["batch_size"], render_cfg=render_cfg,
              use_warp_renders=config["use_warp_renders"], device=dev, layout_model=horizon)

    def score(floor: traffic.Floor, hyps):
        sl = slice(floor.offset, floor.offset + floor.n_panos)
        rows = {i: i for i in range(floor.n_panos)}
        return fused_inference.score_floor_hypotheses(model, cfg, depths[sl], rgbs[sl], rows, hyps,
                                                      wdo_spans=spans[sl], **kw)

    for warm in warmup_floors(mix, seed, config["batch_size"] * 3 // 2):
        score(warm, fs.hypotheses(warm))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    kept = Reservoir(mix["reference_floors"], seed)
    produced: List[torch.Tensor] = []
    computed: List[torch.Tensor] = []
    layout_rasters, floor_boundary_bank = fused_inference.layout_rasters, fused_inference.floor_boundary_bank

    def keep_rasters(*a, **k):
        out = layout_rasters(*a, **k)
        produced.append(out)
        return out

    def keep_boundary(*a, **k):
        out = floor_boundary_bank(*a, **k)
        computed.append(out)
        return out

    done: List[tuple] = []  # (floor index, seconds, results)

    def loop(n_floors=None, deadline=None):
        k = 0
        while True:
            i = k % len(floors)
            t0 = time.perf_counter()
            res = score(floors[i], floor_hyps[i])
            done.append((i, time.perf_counter() - t0, res))
            kept.offer(len(done) - 1, (computed.pop(), list(produced)))
            produced.clear()
            k += 1
            if (n_floors is not None and k >= n_floors) or (deadline is not None and time.perf_counter() >= deadline):
                return

    panos0, vertices0 = profiler.counter("horizon/panos"), profiler.counter("boundary/vertices")
    out: Dict = {"metrics": {}, "ctx": {}}
    fused_inference.layout_rasters, fused_inference.floor_boundary_bank = keep_rasters, keep_boundary
    try:
        if trace:
            t0 = time.perf_counter()
            loop(n_floors=mix["trace_floors"])
            plain_s = time.perf_counter() - t0
            n_plain = len(done)
            spans_ = Spans()
            fs._launch_records(spans_)
            spans_.wrap(fused_inference, "floor_boundary_bank", "horizon",
                        lambda m, rgbs_d, *a: {"panos": int(rgbs_d.shape[0])})
            model.forward = fs._wrapped_forward(model)
            try:
                _, summary = profile(lambda: loop(n_floors=mix["trace_floors"]))
            finally:
                spans_.restore()
                del model.forward
            fs._finish_warp_records(spans_.launches["b3"])
            traced = done[n_plain:]
            out["ctx"] = {"trace": summary, "plain_window_s": plain_s, "launches": dict(spans_.launches),
                          "units": sum(len(r) for _, _, r in traced),
                          "panos": sum(floors[i].n_panos for i, _, _ in traced), "horizon_hw": hw}
        else:
            t0 = time.perf_counter()
            loop(deadline=t0 + seconds)
            window = time.perf_counter() - t0
            ms = [s * 1e3 for _, s, _ in done]
            out["metrics"] = {"hyp_per_s": sum(len(r) for _, _, r in done) / window, "setup_s": setup_s,
                              "floor_p95_ms": float(np.percentile(ms, 95)), "floor_p50_ms": float(np.median(ms))}
            out["window_s"] = window
    finally:
        fused_inference.layout_rasters, fused_inference.floor_boundary_bank = layout_rasters, floor_boundary_bank
    n_panos = profiler.counter("horizon/panos") - panos0
    print(f"horizon_scoring: {n_panos} boundaries computed, {profiler.counter('boundary/vertices') - vertices0} "
          f"room vertices kept ({(profiler.counter('boundary/vertices') - vertices0) / max(n_panos, 1):.1f} a room), "
          f"{fused_inference.HORIZON_CHUNK} panos a forward; output scale {b_scale:.6g}", file=sys.stderr)
    out["floors"] = len(done)
    out["attempted"] = sum(floors[i].n_hypotheses for i, _, _ in done)
    out["failed"] = out["attempted"] - sum(len(r) for _, _, r in done)
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # The program's state goes before the references run.
    answers = [(i, np.array([r.prob if r.y_hat == 1 else 1.0 - r.prob for r in res])) for i, _, res in done]
    held = {pos: (bnd.cpu().numpy(), [t.cpu() for t in calls]) for pos, (bnd, calls) in kept.held.values()}
    del model, horizon, done, kept
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["checks"] = judge(config, mix, seed, depths, rgbs, spans, floors, answers, held, (b_scale, scale), dev)
    return out


def judge(config, mix, seed, depths, rgbs, spans, floors, answers, held: Dict[int, tuple], scales, dev,
          boundaries: Optional[ReferenceBoundaries] = None) -> Dict:
    """boundary_gap_px, layout_gap and logit_gap of the kept floors (`held`:
    position in `answers` -> that floor's (P, w) boundary rows and its
    raster calls) against the float32 references."""
    hw = tuple(config["horizonnet_input_hw"])
    b_scale, scale = scales
    if boundaries is None:
        boundaries = ReferenceBoundaries(reference_state(config, seed, b_scale, dev), rgbs, dev)
    state = make_state_dict(arch_of(config), seed, dev)
    state["fc.weight"].mul_(scale)
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 36]))
    px, mpp, width = config["img_px"], config["meters_per_px"], config["layout_line_px"]
    differ = total = 0
    boundary_gap = logit_gap = 0.0
    for pos in sorted(held):
        i, p1 = answers[pos]
        f = floors[i]
        idx = list(range(f.offset, f.offset + f.n_panos))
        sl = slice(f.offset, f.offset + f.n_panos)
        got_rows, calls = held[pos]
        want_rows = boundaries(idx)
        gap = np.abs(got_rows.astype(np.float64) - want_rows.astype(np.float64))
        boundary_gap = max(boundary_gap, float(gap.max()) if np.all(np.isfinite(gap)) else float("inf"))
        lays = [reference_layout(r, spans[k], hw) for r, k in zip(want_rows, idx)]
        ref1, ref2 = ref_layout.pair_rasters(lays, f.pairs, f.theta_deg, f.t, px, mpp, width, dev)
        got1, got2 = ls.program_rasters(calls, f.n_panos, f.n_hypotheses)
        for got, want in ((got1, ref1), (got2, ref2)):
            n, m = ls.pixel_gap(got, want)
            differ, total = differ + n, total + m
        rows = np.sort(rng.choice(len(p1), size=min(mix["reference_hypotheses"], len(p1)), replace=False))
        ref = ref_score.positive_probs(config, state, depths[sl], rgbs[sl], lays, f.pairs[rows],
                                       f.theta_deg[rows], f.t[rows], dev, rasters=(ref1[rows], ref2))
        d = np.abs(fs.log_odds(ref) - fs.log_odds(p1[rows])) / scale
        logit_gap = max(logit_gap, float(d.max()) if np.all(np.isfinite(d)) else float("inf"))
    return {"boundary_gap_px": boundary_gap, "layout_gap": differ / max(total, 1), "logit_gap": logit_gap}


def control(config: Dict, mix: Dict, seed: int, device, n_floors: int = 3, precision: str = "fp32",
            fault: Optional[str] = None) -> Dict:
    """The control's checks: the reference's boundaries at `precision` ("tf32"
    or "bf16"), or with a planted `fault` (reference/horizonnet.py:FAULTS),
    put in the program's place on the first `n_floors` floors of the seed's
    mix, with the layouts, rasters and answers the float32 reference chain
    makes of them, judged as a run's are."""
    dev = torch.device("cuda" if device is None else device)
    hw = _check(config, mix)
    depths, rgbs = synthetic.pano_pool(mix["pool_panos"], *mix["pano_hw"], seed)
    spans = span_pool(mix["pool_panos"], seed)
    floors = traffic.floors(mix, seed)[:n_floors]
    b_scale = boundary_scale(config, mix, seed, rgbs, dev)
    state_h = reference_state(config, seed, b_scale, dev)
    sound = ReferenceBoundaries(state_h, rgbs, dev)
    scale = head_scale(config, mix, seed, depths, rgbs, spans, sound, dev)
    planted = ReferenceBoundaries(state_h, rgbs, dev, precision, fault)
    state = make_state_dict(arch_of(config), seed, dev)
    state["fc.weight"].mul_(scale)
    px, mpp, width = config["img_px"], config["meters_per_px"], config["layout_line_px"]
    answers, held = [], {}
    for pos, f in enumerate(floors):
        idx = list(range(f.offset, f.offset + f.n_panos))
        sl = slice(f.offset, f.offset + f.n_panos)
        rows = planted(idx)
        lays = [reference_layout(r, spans[k], hw) for r, k in zip(rows, idx)]
        lay1, lay2 = ref_layout.pair_rasters(lays, f.pairs, f.theta_deg, f.t, px, mpp, width, dev)
        answers.append((pos, ref_score.positive_probs(config, state, depths[sl], rgbs[sl], lays, f.pairs,
                                                      f.theta_deg, f.t, dev, rasters=(lay1, lay2))))
        held[pos] = (rows, [lay2, lay1])
    return judge(config, mix, seed, depths, rgbs, spans, floors, answers, held, (b_scale, scale), dev, sound)
