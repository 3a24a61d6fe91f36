"""Driver `fresh_scoring`: freshly uploaded floors scored from RGB alone.

The program under test is `salve_tpu_torch.pipeline.fused_inference.
score_floor_hypotheses` as the `fused_scoring` driver calls it, on the same
floors, but handed no depth: a floor's float32 RGB bank, with `depths=None`
and a HoHoNet `depth_model` (the port's `HoHoNetDepth`, its weights drawn
from the seed on the card and loaded with `load_state_dict(strict=True)`,
as a checkpoint is). The scorer computes every pano's depth on the card in
float32 before it builds the floor's banks; nothing is cached across calls.
The verifier is `fused_scoring`'s, its head scaled on the warm-up floor as
there, with the reference's depth of that floor.

One client, closed loop, whole floors until `seconds` have passed; the
traced run scores the mix's first `trace_floors` floors untraced and then
under the profiler, with `fused_scoring`'s `bench/` ranges and a
`bench/depth` range around the depth stage (`depth_mm_bank`).

`correct` compares what the timed path itself produced with the plain
float32 references (reference/hohonet.py, reference/score.py): the window
keeps the depth bank of `reference_floors` floors, a sample drawn from the
seed as the floors complete, and after the window
* `depth_gap_mm`: the largest |difference| between the kept banks (the
  cache's rounded millimetres) and the reference's depth in millimetres
  before rounding, over every pixel of those floors' panos;
* `logit_gap`: as in `fused_scoring`, up to `reference_hypotheses` of each
  kept floor's answers against the reference chain fed the reference's
  depth rounded as the cache rounds it, in nats of the unscaled head.
"""

from __future__ import annotations

import gc
import inspect
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark import synthetic, traffic
from benchmark.drivers import fused_scoring as fs
from benchmark.hohonet_weights import make_state_dict as hohonet_state
from benchmark.reference import hohonet as ref_hohonet
from benchmark.reference import score as ref_score
from benchmark.tracing import Spans, profile
from benchmark.weights import arch_of, make_state_dict

# The configuration's HoHoNet keys and the published plan's values, which
# the program's model and the reference hold as constants.
PLAN = {"depth_emb_dim": ref_hohonet.EMB, "depth_heads": ref_hohonet.HEADS, "depth_ffn_dim": ref_hohonet.FFN,
        "depth_dct_components": ref_hohonet.DCT, "depth_dtype": "float32"}


def _check(config: Dict, mix: Dict) -> Tuple[int, int]:
    from salve_tpu_torch.pipeline import fused_inference

    if "depth_model" not in inspect.signature(fused_inference.score_floor_hypotheses).parameters:
        raise SystemExit("fresh_scoring: this program's score_floor_hypotheses takes no depth_model, so it "
                         "cannot score a floor from RGB alone")
    bad = {k: config.get(k) for k, v in PLAN.items() if config.get(k) != v}
    if bad or list(config["depth_input_hw"]) != list(mix["pano_hw"]):
        raise ValueError(f"fresh_scoring runs HoHoNet at its plan's widths on panos at its input size; got {bad}, "
                         f"input {config['depth_input_hw']} for panos {mix['pano_hw']}")
    return tuple(config["depth_input_hw"])


def reference_depth_m(config: Dict, seed: int, rgbs: np.ndarray, dev, precision: str = "fp32",
                      state=None) -> torch.Tensor:
    """The reference's (P, H, W) float32 meters of `rgbs` on `dev`."""
    if state is None:
        state = hohonet_state(seed, dev, tuple(config["depth_input_hw"]))
    return ref_hohonet.depth_m(state, torch.as_tensor(rgbs, device=dev), precision)


def head_scale(config: Dict, mix: Dict, seed: int, rgbs: np.ndarray, dev) -> float:
    """`fs.verifier_state`'s scale, on the warm-up floor's first batch fed
    the reference's depth of the floor."""
    state = make_state_dict(arch_of(config), seed, dev)
    warm = traffic.warmup_floor(mix, seed, config["batch_size"])
    sl = slice(warm.offset, warm.offset + int(warm.pairs.max()) + 1)
    depths = ref_hohonet.depth_mm(reference_depth_m(config, seed, rgbs[sl], dev)).cpu().numpy()
    m = ref_score.margins(config, state, depths, rgbs[sl], warm.pairs, warm.theta_deg, warm.t, dev, "fp32")
    return fs.CALIBRATED_LOGIT / max(float(np.abs(m).max()), 1e-3)


def _depth_program(config: Dict, seed: int, dev):
    from salve_tpu_torch.models.hohonet import HoHoNetDepth

    hw = tuple(config["depth_input_hw"])
    model = HoHoNetDepth(hw)
    model.load_state_dict(hohonet_state(seed, dev, hw), strict=True)
    return model.to(dev).eval()


class Reservoir:
    """A uniform sample of `k` of the window's floors, drawn from the seed as
    they complete (Vitter's algorithm R): the depth banks of the floors it
    holds stay on the card until the window ends, the rest go with their call."""

    def __init__(self, k: int, seed: int) -> None:
        self.k, self.n = k, 0
        self.rng = np.random.default_rng(np.random.SeedSequence([int(seed), 33]))
        self.held: Dict[int, Tuple[int, torch.Tensor]] = {}

    def offer(self, position: int, bank: torch.Tensor) -> None:
        slot = self.n if self.n < self.k else int(self.rng.integers(0, self.n + 1))
        self.n += 1
        if slot < self.k:
            self.held[slot] = (position, bank)

    def banks(self) -> Dict[int, np.ndarray]:
        """Position in the window -> the kept (P, H, W) float32 mm bank."""
        return {pos: bank.cpu().numpy() for pos, bank in self.held.values()}


def run(config: Dict, mix: Dict, seed: int, seconds: float, trace: bool, device, t_start: float) -> Dict:
    from salve_tpu_torch.device import resolve_device
    from salve_tpu_torch.pipeline import fused_inference

    hw = _check(config, mix)
    dev = resolve_device(device)
    h, w = mix["pano_hw"]
    _, rgbs = synthetic.pano_pool(mix["pool_panos"], h, w, seed)
    scale = head_scale(config, mix, seed, rgbs, dev)
    state = make_state_dict(arch_of(config), seed, dev)
    state["fc.weight"].mul_(scale)
    cfg, model, render_cfg = fs._program(config, state, dev)
    del state
    depth_model = _depth_program(config, seed, dev)
    floors = traffic.floors(mix, seed)
    floor_hyps = [fs.hypotheses(f) for f in floors]
    kw = dict(batch_size=config["batch_size"], render_cfg=render_cfg,
              use_warp_renders=config["use_warp_renders"], device=dev, depth_model=depth_model)

    def score(floor: traffic.Floor, hyps):
        sl = slice(floor.offset, floor.offset + floor.n_panos)
        rows = {i: i for i in range(floor.n_panos)}
        return fused_inference.score_floor_hypotheses(model, cfg, None, rgbs[sl], rows, hyps, **kw)

    # The depth's one shape (a pano a forward) and the verifier's on the largest floor.
    warm = traffic.warmup_floor(mix, seed, config["batch_size"] * 3 // 2)
    score(warm, fs.hypotheses(warm))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    kept = Reservoir(mix["reference_floors"], seed)
    produced: List[torch.Tensor] = []
    depth_mm_bank = fused_inference.depth_mm_bank

    def keep(*a, **k):
        out = depth_mm_bank(*a, **k)
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
            kept.offer(len(done) - 1, produced.pop())
            k += 1
            if (n_floors is not None and k >= n_floors) or (deadline is not None and time.perf_counter() >= deadline):
                return

    out: Dict = {"metrics": {}, "ctx": {}}
    fused_inference.depth_mm_bank = keep
    try:
        if trace:
            t0 = time.perf_counter()
            loop(n_floors=mix["trace_floors"])
            plain_s = time.perf_counter() - t0
            n_plain = len(done)
            spans = Spans()
            fs._launch_records(spans)
            spans.wrap(fused_inference, "depth_mm_bank", "depth",
                       lambda m, rgbs_d, *a: {"panos": int(rgbs_d.shape[0])})
            model.forward = fs._wrapped_forward(model)
            try:
                _, summary = profile(lambda: loop(n_floors=mix["trace_floors"]))
            finally:
                spans.restore()
                del model.forward
            fs._finish_warp_records(spans.launches["b3"])
            traced = done[n_plain:]
            out["ctx"] = {"trace": summary, "plain_window_s": plain_s, "launches": dict(spans.launches),
                          "units": sum(len(r) for _, _, r in traced),
                          "panos": sum(floors[i].n_panos for i, _, _ in traced), "depth_hw": hw}
        else:
            t0 = time.perf_counter()
            loop(deadline=t0 + seconds)
            window = time.perf_counter() - t0
            ms = [s * 1e3 for _, s, _ in done]
            out["metrics"] = {"hyp_per_s": sum(len(r) for _, _, r in done) / window, "setup_s": setup_s,
                              "floor_p95_ms": float(np.percentile(ms, 95)), "floor_p50_ms": float(np.median(ms))}
            out["window_s"] = window
    finally:
        fused_inference.depth_mm_bank = depth_mm_bank
    out["floors"] = len(done)
    out["attempted"] = sum(floors[i].n_hypotheses for i, _, _ in done)
    out["failed"] = out["attempted"] - sum(len(r) for _, _, r in done)
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # The program's state goes before the references run.
    answers = [(i, np.array([r.prob if r.y_hat == 1 else 1.0 - r.prob for r in res])) for i, _, res in done]
    banks = kept.banks()
    del model, depth_model, done, kept
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["checks"] = judge(config, mix, seed, rgbs, floors, answers, banks, scale, dev)
    return out


def judge(config, mix, seed, rgbs, floors, answers, banks: Dict[int, np.ndarray], scale: float, dev) -> Dict:
    """depth_gap_mm and logit_gap of the kept floors (`banks`: position in
    `answers` -> that floor's depth bank in mm) against the float32 references."""
    hoho = hohonet_state(seed, dev, tuple(config["depth_input_hw"]))
    state = make_state_dict(arch_of(config), seed, dev)
    state["fc.weight"].mul_(scale)
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 34]))
    depth_gap = logit_gap = 0.0
    for pos in sorted(banks):
        i, p1 = answers[pos]
        f = floors[i]
        sl = slice(f.offset, f.offset + f.n_panos)
        ref_m = reference_depth_m(config, seed, rgbs[sl], dev, state=hoho)
        gap = np.abs(banks[pos] - ref_m.cpu().numpy() * np.float32(1000.0))
        depth_gap = max(depth_gap, float(gap.max()) if np.all(np.isfinite(gap)) else float("inf"))
        rows = np.sort(rng.choice(len(p1), size=min(mix["reference_hypotheses"], len(p1)), replace=False))
        ref = ref_score.positive_probs(config, state, ref_hohonet.depth_mm(ref_m).cpu().numpy(), rgbs[sl],
                                       f.pairs[rows], f.theta_deg[rows], f.t[rows], dev, "fp32")
        d = np.abs(fs.log_odds(ref) - fs.log_odds(p1[rows])) / scale
        logit_gap = max(logit_gap, float(d.max()) if np.all(np.isfinite(d)) else float("inf"))
    return {"depth_gap_mm": depth_gap, "logit_gap": logit_gap}


def control(config: Dict, mix: Dict, seed: int, device, n_floors: int, precision: str) -> Dict:
    """The control's checks: the reference's depth at `precision` ("tf32" or
    "bf16") put in the program's place on the first `n_floors` floors of the
    seed's mix, their answers the float32 reference chain fed that depth,
    judged as a run's are."""
    dev = torch.device("cuda" if device is None else device)
    hw = _check(config, mix)
    _, rgbs = synthetic.pano_pool(mix["pool_panos"], *mix["pano_hw"], seed)
    floors = traffic.floors(mix, seed)[:n_floors]
    scale = head_scale(config, mix, seed, rgbs, dev)
    state = make_state_dict(arch_of(config), seed, dev)
    state["fc.weight"].mul_(scale)
    hoho = hohonet_state(seed, dev, hw)
    answers, banks = [], {}
    for pos, f in enumerate(floors):
        sl = slice(f.offset, f.offset + f.n_panos)
        mm = ref_hohonet.depth_mm(reference_depth_m(config, seed, rgbs[sl], dev, precision, state=hoho)).cpu().numpy()
        answers.append((pos, ref_score.positive_probs(config, state, mm, rgbs[sl], f.pairs, f.theta_deg, f.t, dev,
                                                      "fp32")))
        banks[pos] = mm
    return judge(config, mix, seed, rgbs, floors, answers, banks, scale, dev)
