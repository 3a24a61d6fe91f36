"""Driver `fused_scoring`: floors scored by the port's fused scorer.

The program under test is `salve_tpu_torch.pipeline.fused_inference.
score_floor_hypotheses`, called as `cli/test_fused.py` calls it: a floor's
u16 depth and float32 rgb banks as numpy arrays, a pano-id -> row map, the
floor's (i1, i2, AlignmentHypothesis) list, batch 32, warp renders, on the
card. The verifier is the port's `EarlyFusionCEResnet` with the benchmark's
seeded weights (`verifier_state`).

One client, closed loop: the next floor starts when the last returned.
The window runs whole floors until `seconds` have passed (the floor in
flight is finished). The traced run scores the mix's first `trace_floors`
floors instead, once on the host's clock alone and then again under the
profiler, with `bench/` ranges around the scorer's layers: the profiler
lengthens the host's work, so the shares of the card's time take the
untraced pass as their window.

`correct` compares a sample of the window's answers (the mix's
`reference_floors` floors drawn from the seed, up to
`reference_hypotheses` of each) with the plain float32 reference
(reference/score.py): `logit_gap`, the largest gap between the program's
and the reference's log-odds of the positive class, in nats of the
unscaled head (the program's log-odds from its float32 probability;
`verifier_state` says why the head is scaled).
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import synthetic, traffic
from benchmark.reference import score as ref_score
from benchmark.rooflines import fill_bytes, fill_ops, splat_bytes, warp_bytes, warp_reads
from benchmark.tracing import Spans, profile
from benchmark.weights import arch_of, make_state_dict


# The largest log-odds the reference reads on the warm-up floor's first
# batch once the head is scaled: rows of the window a few times past it
# still sit far inside float32's resolution of a probability.
CALIBRATED_LOGIT = 3.0


def verifier_state(config: Dict, mix: Dict, seed: int, depths: np.ndarray, rgbs: np.ndarray, dev):
    """The seed's verifier weights (weights.py) with the head scaled by
    `scale`, so that the float32 reference's largest log-odds on the
    warm-up floor's first batch is CALIBRATED_LOGIT; returns (state, scale).

    A network drawn at random can put its answers within float32's last
    steps of probability 0 or 1, where a gap of log-odds reads rounding (ln
    2 for one step in two), or nothing where both sides read exactly 1.
    Scaling the head scales every log-odds and every gap alike, so the gaps
    are read in the unscaled head's units (divided by `scale`): there they
    are alike across seeds, while the scale differs widely from seed to seed."""
    state = make_state_dict(arch_of(config), seed, dev)
    warm = traffic.warmup_floor(mix, seed, config["batch_size"])
    sl = slice(warm.offset, warm.offset + int(warm.pairs.max()) + 1)
    m = ref_score.margins(config, state, depths[sl], rgbs[sl], warm.pairs, warm.theta_deg, warm.t, dev, "fp32")
    scale = CALIBRATED_LOGIT / max(float(np.abs(m).max()), 1e-3)
    state["fc.weight"].mul_(scale)
    return state, scale


def _program(config: Dict, state: Dict, dev):
    from salve_tpu_torch.models.early_fusion import EarlyFusionCEResnet
    from salve_tpu_torch.rendering.bev_pair import BEVRenderConfig
    from salve_tpu_torch.training.config import TrainingConfig

    cfg = TrainingConfig(num_layers=config["num_layers"], num_ce_classes=config["num_classes"],
                         modalities=tuple(config["modalities"]), compute_dtype=config["compute_dtype"],
                         resize_h=config["resize_px"], resize_w=config["resize_px"],
                         train_h=config["crop_px"], train_w=config["crop_px"])
    model = EarlyFusionCEResnet(num_layers=cfg.num_layers, num_classes=cfg.num_ce_classes,
                                modalities=cfg.modalities, compute_dtype=cfg.compute_dtype)
    model.load_state_dict(state)
    render_cfg = BEVRenderConfig(img_px=config["img_px"], meters_per_px=config["meters_per_px"])
    return cfg, model.to(dev).eval(), render_cfg


def hypotheses(floor: traffic.Floor) -> List:
    """The floor's (i1, i2, AlignmentHypothesis) triples, as the program takes them."""
    from salve_tpu_torch.common.alignment_hypothesis import AlignmentHypothesis
    from salve_tpu_torch.geometry.sim2 import Sim2

    return [(int(i1), int(i2), AlignmentHypothesis(
        i2Ti1=Sim2.from_theta_deg(float(th), t), wdo_alignment_object="door", i1_wdo_idx=k,
        i2_wdo_idx=0, configuration="identity"))
        for k, ((i1, i2), th, t) in enumerate(zip(floor.pairs, floor.theta_deg, floor.t))]


def _launch_records(spans: Spans) -> None:
    """bench/ ranges around the scorer's layers and the three kernels."""
    from salve_tpu_torch.ops import fill, splat, warp
    from salve_tpu_torch.pipeline import fused_inference

    spans.wrap(fused_inference, "build_banks", "build_banks",
               lambda depths, *a, **k: {"panos": int(depths.shape[0])})
    spans.wrap(fused_inference, "score_batch", "score_batch")
    spans.wrap(splat, "splat_priority_grid_cuda", "b1",
               lambda cell, key, ok, h, w: {"bytes": splat_bytes(cell.shape[0], cell.shape[1], h * w), "ops": 0})
    spans.wrap(fill, "fill_and_mask_cuda", "b2",
               lambda sparse, *a: {"bytes": fill_bytes(*sparse.shape[:3]), "ops": fill_ops(*sparse.shape[:3])})

    def warp_record(banks, bank_idx, p):
        n_banks = 1 if isinstance(banks, torch.Tensor) else len(banks)
        bank = banks if n_banks == 1 else banks[0]
        return {"b": int(bank_idx.shape[0]), "d": p.d, "x3": p.x3, "y2": p.y2, "n_banks": n_banks,
                "side": int(bank.shape[-1]), "params": p}

    spans.wrap(warp, "shear_warp_cuda", "b3", warp_record)


def _finish_warp_records(records: List[dict]) -> None:
    """B3's bytes need the cells its outputs read, from each launch's data."""
    for r in records:
        p = r.pop("params")
        reads = warp_reads(p.row0, p.starts1, p.starts2, p.starts3, p.d, p.x3, p.y2, r["side"]) * r["n_banks"]
        r["bytes"] = warp_bytes(r["b"], r["d"], r["x3"], r["y2"], r["n_banks"], reads)
        r["ops"] = 0


def run(config: Dict, mix: Dict, seed: int, seconds: float, trace: bool, device, t_start: float) -> Dict:
    from salve_tpu_torch.device import resolve_device
    from salve_tpu_torch.pipeline import fused_inference

    dev = resolve_device(device)
    h, w = mix["pano_hw"]
    depths, rgbs = synthetic.pano_pool(mix["pool_panos"], h, w, seed)
    cfg, model, render_cfg = _program(config, verifier_state(config, mix, seed, depths, rgbs, dev)[0], dev)
    floors = traffic.floors(mix, seed)
    floor_hyps = [hypotheses(f) for f in floors]
    kw = dict(batch_size=config["batch_size"], render_cfg=render_cfg,
              use_warp_renders=config["use_warp_renders"], device=dev)

    def score(floor: traffic.Floor, hyps):
        sl = slice(floor.offset, floor.offset + floor.n_panos)
        rows = {i: i for i in range(floor.n_panos)}
        return fused_inference.score_floor_hypotheses(model, cfg, depths[sl], rgbs[sl], rows, hyps, **kw)

    warm = traffic.warmup_floor(mix, seed, config["batch_size"] * 3 // 2)
    score(warm, hypotheses(warm))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    # The inputs made in set-up live through the window: keep the collector
    # from walking them again and again.
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    done: List[tuple] = []  # (floor index, seconds, results)

    def loop(n_floors=None, deadline=None):
        k = 0
        while True:
            i = k % len(floors)
            t0 = time.perf_counter()
            res = score(floors[i], floor_hyps[i])
            done.append((i, time.perf_counter() - t0, res))
            k += 1
            if (n_floors is not None and k >= n_floors) or (deadline is not None and time.perf_counter() >= deadline):
                return

    out: Dict = {"metrics": {}, "ctx": {}}
    if trace:
        t0 = time.perf_counter()
        loop(n_floors=mix["trace_floors"])  # ends on the last batch's fetch: the card is idle
        plain_s = time.perf_counter() - t0
        n_plain = len(done)
        spans = Spans()
        _launch_records(spans)
        model.forward = _wrapped_forward(model)
        try:
            _, summary = profile(lambda: loop(n_floors=mix["trace_floors"]))
        finally:
            spans.restore()
            del model.forward
        _finish_warp_records(spans.launches["b3"])
        traced = done[n_plain:]
        out["ctx"] = {"trace": summary, "plain_window_s": plain_s, "launches": dict(spans.launches),
                      "units": sum(len(r) for _, _, r in traced),
                      "panos": sum(floors[i].n_panos for i, _, _ in traced)}
    else:
        t0 = time.perf_counter()
        loop(deadline=t0 + seconds)
        window = time.perf_counter() - t0
        ms = [s * 1e3 for _, s, _ in done]
        out["metrics"] = {"hyp_per_s": sum(len(r) for _, _, r in done) / window, "setup_s": setup_s,
                          "floor_p95_ms": float(np.percentile(ms, 95)), "floor_p50_ms": float(np.median(ms))}
        out["window_s"] = window
    out["floors"] = len(done)
    out["attempted"] = sum(floors[i].n_hypotheses for i, _, _ in done)
    out["failed"] = out["attempted"] - sum(len(r) for _, _, r in done)
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # The program's state goes before the reference runs.
    answers = [(i, np.array([r.prob if r.y_hat == 1 else 1.0 - r.prob for r in res])) for i, _, res in done]
    del model, done
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["checks"] = judge(config, mix, seed, depths, rgbs, floors, answers, dev, precision="fp32")
    return out


def _wrapped_forward(model):
    forward = model.forward

    def traced(*a, **k):
        with torch.profiler.record_function("bench/verifier"):
            return forward(*a, **k)

    return traced


def sample(mix: Dict, seed: int, answers) -> List[tuple]:
    """The answers the reference checks: `reference_floors` of the window's
    floors drawn from the seed, up to `reference_hypotheses` rows of each."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 31]))
    picks = rng.choice(len(answers), size=min(mix["reference_floors"], len(answers)), replace=False)
    out = []
    for j in sorted(picks):
        i, p1 = answers[j]
        rows = np.sort(rng.choice(len(p1), size=min(mix["reference_hypotheses"], len(p1)), replace=False))
        out.append((i, rows, p1[rows]))
    return out


def judge(config, mix, seed, depths, rgbs, floors, answers, dev, precision: str) -> Dict:
    """logit_gap of the sampled answers against the reference at `precision`,
    in log-odds of the unscaled head (verifier_state)."""
    state, scale = verifier_state(config, mix, seed, depths, rgbs, dev)
    gap = 0.0
    for i, rows, p1 in sample(mix, seed, answers):
        f = floors[i]
        sl = slice(f.offset, f.offset + f.n_panos)
        ref = ref_score.positive_probs(config, state, depths[sl], rgbs[sl], f.pairs[rows], f.theta_deg[rows],
                                       f.t[rows], dev, precision)
        d = np.abs(log_odds(ref) - log_odds(p1)) / scale
        gap = max(gap, float(d.max()) if np.all(np.isfinite(d)) else float("inf"))
    return {"logit_gap": gap}


def log_odds(p: np.ndarray) -> np.ndarray:
    p = np.clip(np.asarray(p, dtype=np.float64), 1e-7, 1 - 1e-7)
    return np.log(p) - np.log1p(-p)


def control(config: Dict, mix: Dict, seed: int, device, n_floors: int, precision: str = "fp8") -> Dict:
    """The control's checks: the reference at `precision` put in the program's
    place on the first `n_floors` floors of the seed's mix, judged as a
    run's answers are."""
    dev = torch.device("cuda" if device is None else device)
    h, w = mix["pano_hw"]
    depths, rgbs = synthetic.pano_pool(mix["pool_panos"], h, w, seed)
    floors = traffic.floors(mix, seed)[:n_floors]
    answers = [(i, np.full(f.n_hypotheses, np.nan)) for i, f in enumerate(floors)]
    state, _ = verifier_state(config, mix, seed, depths, rgbs, dev)
    for i, rows, _ in sample(mix, seed, answers):
        f = floors[i]
        sl = slice(f.offset, f.offset + f.n_panos)
        answers[i][1][rows] = ref_score.positive_probs(config, state, depths[sl], rgbs[sl], f.pairs[rows],
                                                       f.theta_deg[rows], f.t[rows], dev, precision)
    return judge(config, mix, seed, depths, rgbs, floors, answers, dev, precision="fp32")
