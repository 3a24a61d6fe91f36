"""Driver `layout_scoring`: floors scored by the ceiling + floor RGB + layout
verifier in the port's fused scorer.

The program under test is `salve_tpu_torch.pipeline.fused_inference.
score_floor_hypotheses` as the `fused_scoring` driver calls it, on the same
floors, with a six-image verifier (its weights drawn from the seed for 6 x
3 input channels) and each floor's room layouts: one (room vertices,
W/D/Os) a pano, drawn for the pool from the seed (layouts.py: 537-607
vertices a room, as a layout detector's boundary leaves after RDP). The
scorer draws pano 2's layouts once a floor and pano 1's, moved by each
row's hypothesis, once a batch, beside the banks' ceiling and floor renders.

One client, closed loop, whole floors until `seconds` have passed; the
traced run scores the mix's first `trace_floors` floors untraced and then
under the profiler, with `fused_scoring`'s `bench/` ranges and a
`bench/layout` range around each raster call (`layout_rasters`), whose
work layout_work.py counts from the call's host arrays.

`correct` compares what the timed path itself produced with the plain
float32 references (reference/layout.py, reference/score_layout.py): the
window keeps the layout rasters of `reference_floors` floors, a sample
drawn from the seed as the floors complete, and after the window
* `layout_gap`: the share of those floors' layout pixels, pano 2's a pano
  and pano 1's a hypothesis, whose u8 value differs from the reference's
  raster by more than one level in a channel;
* `logit_gap`: as in `fused_scoring`, up to `reference_hypotheses` of each
  kept floor's answers against the reference chain fed the reference's own
  layout rasters, in nats of the unscaled head.
"""

from __future__ import annotations

import gc
import inspect
import sys
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark import layout_work, layouts, synthetic, traffic
from benchmark.drivers import fused_scoring as fs
from benchmark.drivers.fresh_scoring import Reservoir
from benchmark.reference import layout as ref_layout
from benchmark.reference import score_layout as ref_score
from benchmark.tracing import Spans, profile
from benchmark.weights import arch_of, make_state_dict

# Levels by which a program pixel may differ from the reference's before it
# counts toward layout_gap: the anti-aliased ramp's rounding ties.
LEVELS = 1


def _check(config: Dict) -> None:
    from salve_tpu_torch.pipeline import fused_inference

    if "layouts" not in inspect.signature(fused_inference.score_floor_hypotheses).parameters:
        raise SystemExit("layout_scoring: this program's score_floor_hypotheses takes no layouts, so it cannot "
                         "score a layout verifier")
    if "layout" not in config["modalities"] or config["n_images"] != 6:
        raise ValueError(f"layout_scoring runs the six-image layout verifier; got {config['modalities']}")


def head_scale(config: Dict, mix: Dict, seed: int, depths, rgbs, pool, dev) -> float:
    """`fs.verifier_state`'s scale, for the six-image verifier."""
    state = make_state_dict(arch_of(config), seed, dev)
    warm = traffic.warmup_floor(mix, seed, config["batch_size"])
    sl = slice(warm.offset, warm.offset + int(warm.pairs.max()) + 1)
    m = ref_score.margins(config, state, depths[sl], rgbs[sl], pool[sl], warm.pairs, warm.theta_deg, warm.t, dev)
    return fs.CALIBRATED_LOGIT / max(float(np.abs(m).max()), 1e-3)


def program_layouts(floor_pool: List[layouts.Layout]) -> List[Tuple[np.ndarray, list]]:
    """The floor's layouts as the program takes them: (room, W/D/Os) a pano."""
    from salve_tpu_torch.common.wdo import WDO
    from salve_tpu_torch.geometry.sim2 import Sim2

    return [(x.room, [WDO(Sim2.identity(), p1, p2, -np.nan, np.nan, kind) for kind, p1, p2 in x.wdos])
            for x in floor_pool]


def run(config: Dict, mix: Dict, seed: int, seconds: float, trace: bool, device, t_start: float) -> Dict:
    from salve_tpu_torch.device import resolve_device
    from salve_tpu_torch.pipeline import fused_inference

    _check(config)
    dev = resolve_device(device)
    h, w = mix["pano_hw"]
    depths, rgbs = synthetic.pano_pool(mix["pool_panos"], h, w, seed)
    pool = layouts.layout_pool(mix["pool_panos"], seed)
    print(f"layout_scoring: {layouts.describe(pool)}", file=sys.stderr)
    scale = head_scale(config, mix, seed, depths, rgbs, pool, dev)
    state = make_state_dict(arch_of(config), seed, dev)
    state["fc.weight"].mul_(scale)
    cfg, model, render_cfg = fs._program(config, state, dev)
    del state
    floors = traffic.floors(mix, seed)
    floor_hyps = [fs.hypotheses(f) for f in floors]
    pool_program = program_layouts(pool)
    kw = dict(batch_size=config["batch_size"], render_cfg=render_cfg,
              use_warp_renders=config["use_warp_renders"], device=dev)

    def score(floor: traffic.Floor, hyps):
        sl = slice(floor.offset, floor.offset + floor.n_panos)
        rows = {i: i for i in range(floor.n_panos)}
        return fused_inference.score_floor_hypotheses(model, cfg, depths[sl], rgbs[sl], rows, hyps,
                                                      layouts=pool_program[sl], **kw)

    warm = traffic.warmup_floor(mix, seed, config["batch_size"] * 3 // 2)
    score(warm, fs.hypotheses(warm))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    kept = Reservoir(mix["reference_floors"], seed)
    produced: List[torch.Tensor] = []
    layout_rasters = fused_inference.layout_rasters

    def keep(*a, **k):
        out = layout_rasters(*a, **k)
        produced.append(out)
        return out

    done: List[tuple] = []  # (floor index, seconds, results)

    def loop(n_floors=None, deadline=None):
        k = 0
        while True:
            i = k % len(floors)
            t0 = time.perf_counter()
            res = score(floors[i], floor_hyps[i])
            done.append((i, time.perf_counter() - t0, res))
            kept.offer(len(done) - 1, list(produced))
            produced.clear()
            k += 1
            if (n_floors is not None and k >= n_floors) or (deadline is not None and time.perf_counter() >= deadline):
                return

    out: Dict = {"metrics": {}, "ctx": {}}
    fused_inference.layout_rasters = keep
    try:
        if trace:
            t0 = time.perf_counter()
            loop(n_floors=mix["trace_floors"])
            plain_s = time.perf_counter() - t0
            n_plain = len(done)
            spans = Spans()
            fs._launch_records(spans)
            spans.wrap(fused_inference, "layout_rasters", "layout",
                       lambda verts, n_v, segs, colors, n_w, rcfg, d: layout_work.work(
                           verts, n_v, segs, n_w, rcfg.img_px, rcfg.meters_per_px, config["layout_line_px"]))
            model.forward = fs._wrapped_forward(model)
            try:
                _, summary = profile(lambda: loop(n_floors=mix["trace_floors"]))
            finally:
                spans.restore()
                del model.forward
            fs._finish_warp_records(spans.launches["b3"])
            traced = done[n_plain:]
            b = config["batch_size"]
            out["ctx"] = {"trace": summary, "plain_window_s": plain_s, "launches": dict(spans.launches),
                          "units": sum(len(r) for _, _, r in traced),
                          "panos": sum(floors[i].n_panos for i, _, _ in traced),
                          "batches": sum(-(-floors[i].n_hypotheses // b) for i, _, _ in traced)}
        else:
            t0 = time.perf_counter()
            loop(deadline=t0 + seconds)
            window = time.perf_counter() - t0
            ms = [s * 1e3 for _, s, _ in done]
            out["metrics"] = {"hyp_per_s": sum(len(r) for _, _, r in done) / window, "setup_s": setup_s,
                              "floor_p95_ms": float(np.percentile(ms, 95)), "floor_p50_ms": float(np.median(ms))}
            out["window_s"] = window
    finally:
        fused_inference.layout_rasters = layout_rasters
    out["floors"] = len(done)
    out["attempted"] = sum(floors[i].n_hypotheses for i, _, _ in done)
    out["failed"] = out["attempted"] - sum(len(r) for _, _, r in done)
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # The program's state goes before the references run.
    answers = [(i, np.array([r.prob if r.y_hat == 1 else 1.0 - r.prob for r in res])) for i, _, res in done]
    held = {pos: [t.cpu() for t in calls] for pos, calls in kept.held.values()}
    del model, done, kept
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["checks"] = judge(config, mix, seed, depths, rgbs, pool, floors, answers, held, scale, dev)
    return out


def program_rasters(calls: List[torch.Tensor], n_panos: int, n_hypotheses: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A floor's raster calls (its bank, then one a batch, padded rows
    last) -> (pano 1's a hypothesis, pano 2's a pano)."""
    bank = calls[0]
    if bank.shape[0] != n_panos:
        raise RuntimeError(f"the floor's first layout call drew {bank.shape[0]} rasters for {n_panos} panos")
    return torch.cat(calls[1:])[:n_hypotheses], bank


def pixel_gap(got: torch.Tensor, want: torch.Tensor) -> Tuple[int, int]:
    """(pixels whose value differs by more than LEVELS in a channel, pixels)."""
    d = (got.to(torch.int16) - want.to(got.device).to(torch.int16)).abs().amax(dim=-1)
    return int((d > LEVELS).sum()), d.numel()


def judge(config, mix, seed, depths, rgbs, pool, floors, answers, held: Dict[int, List[torch.Tensor]], scale: float,
          dev) -> Dict:
    """layout_gap and logit_gap of the kept floors (`held`: position in
    `answers` -> that floor's raster calls) against the float32 references."""
    state = make_state_dict(arch_of(config), seed, dev)
    state["fc.weight"].mul_(scale)
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 35]))
    px, mpp, width = config["img_px"], config["meters_per_px"], config["layout_line_px"]
    differ = total = 0
    logit_gap = 0.0
    for pos in sorted(held):
        i, p1 = answers[pos]
        f = floors[i]
        sl = slice(f.offset, f.offset + f.n_panos)
        ref1, ref2 = ref_layout.pair_rasters(pool[sl], f.pairs, f.theta_deg, f.t, px, mpp, width, dev)
        got1, got2 = program_rasters(held[pos], f.n_panos, f.n_hypotheses)
        for got, want in ((got1, ref1), (got2, ref2)):
            n, m = pixel_gap(got, want)
            differ, total = differ + n, total + m
        rows = np.sort(rng.choice(len(p1), size=min(mix["reference_hypotheses"], len(p1)), replace=False))
        ref = ref_score.positive_probs(config, state, depths[sl], rgbs[sl], pool[sl], f.pairs[rows],
                                       f.theta_deg[rows], f.t[rows], dev, rasters=(ref1[rows], ref2))
        d = np.abs(fs.log_odds(ref) - fs.log_odds(p1[rows])) / scale
        logit_gap = max(logit_gap, float(d.max()) if np.all(np.isfinite(d)) else float("inf"))
    return {"layout_gap": differ / max(total, 1), "logit_gap": logit_gap}


def control(config: Dict, mix: Dict, seed: int, device, n_floors: int = 3, precision: str = "bf16") -> Dict:
    """The control's checks: the reference with its layouts' vertices at
    `precision` put in the program's place on the first `n_floors` floors of
    the seed's mix (its rasters and its chain's answers), judged as a run's
    are."""
    dev = torch.device("cuda" if device is None else device)
    h, w = mix["pano_hw"]
    depths, rgbs = synthetic.pano_pool(mix["pool_panos"], h, w, seed)
    pool = layouts.layout_pool(mix["pool_panos"], seed)
    floors = traffic.floors(mix, seed)[:n_floors]
    scale = head_scale(config, mix, seed, depths, rgbs, pool, dev)
    state = make_state_dict(arch_of(config), seed, dev)
    state["fc.weight"].mul_(scale)
    px, mpp, width = config["img_px"], config["meters_per_px"], config["layout_line_px"]
    answers, held = [], {}
    for pos, f in enumerate(floors):
        sl = slice(f.offset, f.offset + f.n_panos)
        lay1, lay2 = ref_layout.pair_rasters(pool[sl], f.pairs, f.theta_deg, f.t, px, mpp, width, dev, precision)
        answers.append((pos, ref_score.positive_probs(config, state, depths[sl], rgbs[sl], pool[sl], f.pairs,
                                                      f.theta_deg, f.t, dev, rasters=(lay1, lay2))))
        held[pos] = [lay2, lay1]
    return judge(config, mix, seed, depths, rgbs, pool, floors, answers, held, scale, dev)
