"""Chip smoke: drive salve_tpu_torch's fused scoring path on one CUDA card.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's nvcc. Exits non-zero, printing no result, without a card or
outside a checkout of the repository.

Phases:
  1. build the three CUDA kernels from `salve_tpu_torch/csrc` (timed);
  2. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes (4 synthetic 512x1024 panos; 501^2 renders, 1001^2
     warp banks, 32 hypotheses): B1 splat, B2 fill + mask and B3 shear warp
     must agree exactly;
  3. run `score_floor_hypotheses` at full width (ResNet-152 early-fusion
     verifier with seeded random weights, resize 234 / crop 224, bf16,
     batch 32): 2560 hypotheses in warp mode, then 1024 in direct mode, each
     with the launch counts zeroed just before and read just after; then a
     small-input check of the card's path against the port's plain CPU
     path, and the median ms of the warp-mode path's parts (banks, one
     score batch, the verifier alone);
  4. time each kernel, its plain version and (B1) the library call,
     median of CUDA-event timings, beside the bound computed from this
     run's inputs; for B1 also the L2-atomic bound, from the atomicMax rate
     this card shows into a grid of the same size.

The last three lines: the `kernels` JSON, the card's name and power limit,
and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

# Published H100 SXM peaks (NVIDIA data sheet) at the full 700 W limit.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Float operations a cell of the fill kernel (csrc/fill.cu): 6 rounds of
# 17 (row pass) + 15 (column pass and update), and 22 adds for the 11x11
# support count.
FILL_OPS_PER_CELL = 6 * (17 + 15) + 22
# Hypotheses of the main path's runs: each mode scores for about a second or
# more, so the per-floor banks and host jitter do not set the rate.
N_WARP_HYPS = 2560
N_DIRECT_HYPS = 1024
# Atomics of one L2-rate probe launch (csrc/splat.cu:salve_l2_atomic_probe).
PROBE_ATOMICS = 1 << 26

REPLACES = {
    "splat": "salve_tpu/ops/pallas_splat.py:77",
    "fill": "salve_tpu/ops/pallas_fill.py:132",
    "warp": "salve_tpu/ops/pallas_warp.py:430",
}
SOURCES = {
    "splat": "salve_tpu_torch/csrc/splat.cu",
    "fill": "salve_tpu_torch/csrc/fill.cu",
    "warp": "salve_tpu_torch/csrc/warp.cu",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, rounds: int = 5, per_round: int = 10, warmup: int = 2) -> float:
    """Median over `rounds` of the mean ms of `per_round` back-to-back calls.

    CUDA events bracket each round, so the card's queue stays full and a slow
    host adds no idle gaps between the events of a single short call.
    """
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per_round):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / per_round)
    return statistics.median(times)


def max_abs_diff(x, y) -> float:
    return float((x.double() - y.double()).abs().max())


def make_hypotheses(n: int, seed: int, n_panos: int):
    import numpy as np

    from salve_tpu_torch.common.alignment_hypothesis import AlignmentHypothesis
    from salve_tpu_torch.geometry.sim2 import Sim2

    rng = np.random.default_rng(seed)
    hyps = []
    for k in range(n):
        i1, i2 = (int(x) for x in rng.choice(n_panos, 2, replace=False))
        hyps.append((i1, i2, AlignmentHypothesis(
            i2Ti1=Sim2.from_theta_deg(float(rng.uniform(-180, 180)), rng.uniform(-2, 2, 2)),
            wdo_alignment_object="door", i1_wdo_idx=k, i2_wdo_idx=0, configuration="identity",
        )))
    return hyps


def run(dev) -> dict:
    """All phases on the CUDA card `dev`, at full width."""
    import numpy as np
    import torch

    from salve_tpu_torch import device as device_mod
    from salve_tpu_torch.dataset.synthetic_bank import make_synthetic_pano_bank
    from salve_tpu_torch.models.early_fusion import EarlyFusionCEResnet
    from salve_tpu_torch.ops import bev, fill, kernels, splat, warp
    from salve_tpu_torch.ops.backproject import FLOOR_Z_RANGE
    from salve_tpu_torch.pipeline.fused_inference import score_floor_hypotheses
    from salve_tpu_torch.rendering.bev_pair import BEVRenderConfig, surface_clouds
    from salve_tpu_torch.training.config import TrainingConfig

    n_panos, pano_h, pano_w, img_px, batch = 4, 512, 1024, 500, 32
    render_cfg = BEVRenderConfig(img_px=img_px)
    bank_px = 2 * img_px
    report = {"kernels": {}, "batch": batch}

    # -- Phase 1: build ------------------------------------------------------
    t0 = time.perf_counter()
    lib = kernels.load()
    log(f"phase 1: kernels built in {lib.build_seconds:.1f} s "
        f"(load {time.perf_counter() - t0:.1f} s): {lib.path}")
    for line in lib.ptxas_log.splitlines():
        if "registers" in line or line.startswith("=="):
            log("  " + line.strip())

    # -- Phase 2: kernels against their plain versions ----------------------
    depths_np, rgbs_np = make_synthetic_pano_bank(n_panos, pano_h, pano_w, seed=0)
    depths = torch.as_tensor(depths_np.astype(np.float32), device=dev)
    rgbs = torch.as_tensor(rgbs_np, device=dev)
    xyz, c, v = surface_clouds(depths, rgbs, FLOOR_Z_RANGE, render_cfg)
    err = {"splat": 0.0, "fill": 0.0, "warp": 0.0}
    timing_inputs = {}
    for px in (img_px, bank_px):
        side = px + 1
        xy_img, z, rgb255, valid = bev.splat_inputs(xyz, c, v, px, render_cfg.meters_per_px)
        cell, key, ok = splat.splat_keys(xy_img, z, valid, side, side)
        got = splat.splat_priority_grid(cell, key, ok, side, side)
        ref = splat.splat_priority_grid_plain(cell, key, ok, side, side)
        e = max_abs_diff(got, ref)
        log(f"phase 2: B1 splat {n_panos}x{side}^2 from {cell.shape[1]} points: max |diff| {e}")
        if not torch.equal(got, ref):
            raise AssertionError("B1 splat disagrees with its plain version")
        err["splat"] = max(err["splat"], e)

        sparse, occ = splat.splat_zorder_batched(xy_img, z, rgb255, valid, side, side, quantize_u8=True)
        support = (torch.clamp(torch.round(sparse), 0, 255) > 0).all(dim=-1)
        sparse, occ, support = sparse.contiguous(), occ.contiguous(), support.contiguous()
        got = fill.fill_and_mask(sparse, occ, support)
        ref = fill.fill_and_mask_plain(sparse, occ, support)
        e = max_abs_diff(got, ref)
        log(f"phase 2: B2 fill {n_panos}x{side}^2: max |diff| {e}")
        if not torch.equal(got, ref):
            raise AssertionError("B2 fill+mask disagrees with its plain version")
        err["fill"] = max(err["fill"], e)
        timing_inputs[px] = (cell, key, ok, sparse, occ, support)

    ext = warp.pack_rgb888(
        warp.render_identity_bank_extended(depths, rgbs, FLOOR_Z_RANGE, render_cfg, bank_px)
    ).contiguous()
    rng = np.random.default_rng(1)
    th = rng.uniform(-np.pi, np.pi, batch)
    R = torch.as_tensor(np.stack(
        [np.stack([np.cos(th), -np.sin(th)], -1), np.stack([np.sin(th), np.cos(th)], -1)], 1
    ).astype(np.float32), device=dev)
    t = torch.as_tensor(rng.uniform(-3, 3, (batch, 2)).astype(np.float32), device=dev)
    idx = torch.as_tensor(rng.integers(0, n_panos, batch), device=dev)
    params = warp.shear_warp_params(R, t, ext.shape[1], img_px, render_cfg.meters_per_px)
    got = warp.shear_warp(ext, idx, params)
    ref = warp.shear_warp_plain(ext, idx, params)
    e = max_abs_diff(got, ref)
    log(f"phase 2: B3 warp {batch} hypotheses {ext.shape[1]}^2 -> {params.d}^2: max |diff| {e}, "
        f"rot90 counts {torch.bincount(params.n.long(), minlength=4).tolist()}")
    if not torch.equal(got, ref):
        raise AssertionError("B3 shear warp disagrees with its plain version")
    err["warp"] = e
    # Bank rows outside [0, P) read as empty pages in both versions.
    idx_out = idx.clone()
    idx_out[:2] = torch.tensor([-1, n_panos], device=dev)
    got = warp.shear_warp(ext, idx_out, params)
    if not torch.equal(got, warp.shear_warp_plain(ext, idx_out, params)) or got[:2].any():
        raise AssertionError("B3 and its plain version disagree on rows outside the bank")
    log("phase 2: B3 warp reads rows outside the bank as empty, as its plain version does")
    # Bank reads this run's data needs: outputs whose pass chain lands in the source.
    n_reads = int((warp.shear_warp_plain(torch.ones_like(ext), idx, params)[..., 2] > 0).sum())

    # -- Phase 3: the main path ----------------------------------------------
    cfg = TrainingConfig(num_layers=152, resize_h=234, resize_w=234, train_h=224, train_w=224, batch_size=batch,
                         compute_dtype="bfloat16")
    torch.manual_seed(0)
    model = EarlyFusionCEResnet(num_layers=cfg.num_layers, compute_dtype=cfg.compute_dtype)
    id2row = {p: p for p in range(n_panos)}
    hyps = make_hypotheses(N_WARP_HYPS, seed=2, n_panos=n_panos)
    # Warm-up (cuDNN plans, allocator); its launches are not the measured run.
    score_floor_hypotheses(model, cfg, depths_np, rgbs_np, id2row, hyps[:batch], batch,
                           render_cfg, use_warp_renders=True, device=dev)
    torch.cuda.synchronize()

    runs = {}
    for mode, warp_on, hs in (("warp", True, hyps), ("direct", False, hyps[:N_DIRECT_HYPS])):
        device_mod.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = score_floor_hypotheses(model, cfg, depths_np, rgbs_np, id2row, hs, batch,
                                     render_cfg, use_warp_renders=warp_on, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = device_mod.launch_counts()
        if len(res) != len(hs):
            raise AssertionError(f"{mode}: {len(res)} results for {len(hs)} hypotheses")
        for r in res:
            if r.y_hat not in (0, 1) or not np.isfinite(r.prob) or not 0.0 <= r.prob <= 1.0:
                raise AssertionError(f"{mode}: bad result {r}")
        runs[mode] = {"hypotheses": len(hs), "seconds": secs, "hyp_per_s": len(hs) / secs,
                      "launches": counts}
        log(f"phase 3: {mode} mode scored {len(hs)} hypotheses in {secs:.3f} s "
            f"({len(hs) / secs:.1f} hyp/s), launches {counts}, "
            f"y_hat=1 share {np.mean([r.y_hat for r in res]):.3f}")
    for k in ("splat", "fill"):
        if runs["direct"]["launches"][k] == 0:
            raise AssertionError(f"direct mode never launched {k}")
    for k in ("splat", "fill", "warp"):
        if runs["warp"]["launches"][k] == 0:
            raise AssertionError(f"warp mode never launched {k}")
    check_small_input(dev)
    report["breakdown"] = time_breakdown(model, cfg, render_cfg, depths, rgbs, hyps[:batch], dev)
    log("phase 3: warp mode, median ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in report["breakdown"].items()))

    # -- Phase 4: times beside bounds -----------------------------------------
    cell, key, ok, sparse, occ, support = timing_inputs[bank_px]
    side = bank_px + 1
    b, n = cell.shape
    hw = side * side
    flat = (torch.arange(b, device=dev)[:, None] * hw + cell.long())[ok]
    src = key[ok]
    lib_grid = torch.full((b * hw,), -1, dtype=torch.int32, device=dev)
    k = report["kernels"]
    k["splat"] = {
        "shape": f"{b}x{n} points -> {b}x{side}^2 grid",
        "ms": time_ms(lambda: splat.splat_priority_grid(cell, key, ok, side, side)),
        "plain_ms": time_ms(lambda: splat.splat_priority_grid_plain(cell, key, ok, side, side)),
        "library_ms": time_ms(lambda: lib_grid.scatter_reduce_(0, flat, src, "amax", include_self=True)),
        "bound_ms": (b * n * 9 + b * hw * 4) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
    }
    # B1's second bound: one L2 atomic per accepted point, at the fastest
    # atomicMax rate this card showed into a grid of the same size.
    rates = l2_atomic_rates(lib.lib, b * hw, dev)
    accepted = int(ok.sum())
    k["splat"].update(accepted_points=accepted, l2_atomics_per_s=rates,
                      l2_bound_ms=accepted / max(rates.values()) * 1e3)
    log(f"phase 4: L2 atomicMax rate into a {b}x{side}^2 grid: "
        + ", ".join(f"{p} {r:.4e}/s" for p, r in rates.items())
        + f"; {accepted} accepted points -> L2 bound {k['splat']['l2_bound_ms']:.4f} ms")
    cells = sparse.shape[0] * sparse.shape[1] * sparse.shape[2]
    k["fill"] = {
        "shape": f"{sparse.shape[0]}x{side}^2x3",
        "ms": time_ms(lambda: fill.fill_and_mask(sparse, occ, support)),
        "plain_ms": time_ms(lambda: fill.fill_and_mask_plain(sparse, occ, support)),
        "library_ms": None,
    }
    f_bytes, f_ops = cells * 26 / HBM_BYTES_PER_S, cells * FILL_OPS_PER_CELL / FP32_OPS_PER_S
    k["fill"].update(bound_ms=max(f_bytes, f_ops) * 1e3, bound_by="bytes" if f_bytes >= f_ops else "operations")
    d = params.d
    w_bytes = batch * d * d * 3 + n_reads * 4 + batch * (params.y2 + params.x3 + d + 2) * 4 + batch * 8
    k["warp"] = {
        "shape": f"{batch}x{ext.shape[1]}^2 bank rows -> {batch}x{d}^2x3",
        "ms": time_ms(lambda: warp.shear_warp(ext, idx, params)),
        "plain_ms": time_ms(lambda: warp.shear_warp_plain(ext, idx, params)),
        "library_ms": None,
        "bound_ms": w_bytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
    }
    for name, row in k.items():
        row.update(name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
                   launches=runs["warp"]["launches"][name],
                   launches_direct=runs["direct"]["launches"][name],
                   max_abs_err=err[name])
        log(f"phase 4: {name}: {row['ms']:.4f} ms (plain {row['plain_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms by {row['bound_by']})")
    report["runs"] = runs
    return report


def l2_atomic_rates(lib, cells: int, dev) -> dict:
    """int32 atomicMax per second into an L2-resident grid of `cells` words,
    with a warp's atomics on adjacent words and spread over cache lines."""
    import torch

    from salve_tpu_torch.ops import kernels

    grid = torch.zeros(cells, dtype=torch.int32, device=dev)
    rates = {}
    for pattern, stride in (("adjacent", 1), ("spread", 7919)):
        def probe(stride=stride):
            kernels.check(lib.salve_l2_atomic_probe(
                grid.data_ptr(), cells, PROBE_ATOMICS, stride, kernels.stream_handle()), "probe")
        rates[pattern] = PROBE_ATOMICS / (time_ms(probe) * 1e-3)
    return rates


def time_breakdown(model, cfg, render_cfg, depths, rgbs, hyps, dev) -> dict:
    """Median ms of the warp-mode path's parts on `dev`: the per-floor banks,
    one score batch (warps, resize, preprocessing, verifier) and the verifier
    alone on a batch of the same shape."""
    import numpy as np
    import torch

    from salve_tpu_torch.pipeline.fused_inference import build_banks, score_batch

    banks = build_banks(depths, rgbs, render_cfg, True)
    i1 = torch.tensor([h[0] for h in hyps], device=dev)
    i2 = torch.tensor([h[1] for h in hyps], device=dev)
    R = torch.as_tensor(np.stack([h[2].i2Ti1.rotation for h in hyps]), device=dev)
    t = torch.as_tensor(np.stack([h[2].i2Ti1.translation for h in hyps]), device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    images = [torch.randn(len(hyps), 3, cfg.train_h, cfg.train_w, generator=gen, device=dev)
              for _ in range(4)]
    with torch.no_grad():
        return {
            "banks_per_floor": time_ms(lambda: build_banks(depths, rgbs, render_cfg, True)),
            "score_batch": time_ms(
                lambda: score_batch(model, cfg, render_cfg, True, *banks, i1, i2, R, t)),
            "verifier_alone": time_ms(lambda: model(images)),
        }


def check_small_input(dev) -> None:
    """The card's path against the port's plain CPU path on a small floor.

    Direct mode, float32, ResNet-18: B1 and B2 on the card, their plain
    versions on the CPU. Renders can differ where a one-ulp sin/cos
    difference moves a round(), so the class-1 probabilities are compared
    within 1e-3 and labels only where the probability is clear of 0.5.
    """
    import numpy as np
    import torch

    from salve_tpu_torch.dataset.synthetic_bank import make_synthetic_pano_bank
    from salve_tpu_torch.models.early_fusion import EarlyFusionCEResnet
    from salve_tpu_torch.pipeline.fused_inference import score_floor_hypotheses
    from salve_tpu_torch.rendering.bev_pair import BEVRenderConfig
    from salve_tpu_torch.training.config import TrainingConfig

    depths, rgbs = make_synthetic_pano_bank(3, 64, 128, seed=3)
    cfg = TrainingConfig(num_layers=18, resize_h=64, resize_w=64, train_h=56, train_w=56,
                         compute_dtype="float32")
    rcfg = BEVRenderConfig(img_px=100, meters_per_px=0.1)
    torch.manual_seed(1)
    model = EarlyFusionCEResnet(num_layers=18, compute_dtype="float32")
    hyps = make_hypotheses(8, seed=4, n_panos=3)
    out = {}
    for d in (dev, torch.device("cpu")):
        res = score_floor_hypotheses(model, cfg, depths, rgbs, {0: 0, 1: 1, 2: 2}, hyps, 8,
                                     rcfg, use_warp_renders=False, device=d)
        out[d.type] = np.array([r.prob if r.y_hat == 1 else 1.0 - r.prob for r in res])
    diff = np.abs(out["cuda"] - out["cpu"])
    clear = np.abs(out["cpu"] - 0.5) > 1e-3
    log(f"phase 3: small-input check, card vs CPU class-1 probs: max |diff| {diff.max():.3e}")
    if diff.max() > 1e-3 or not np.array_equal(out["cuda"][clear] > 0.5, out["cpu"][clear] > 0.5):
        raise AssertionError("the card's path disagrees with the plain CPU path on a small input")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    # The port is the package beside this script, never an installed copy.
    repo = Path(__file__).resolve().parent
    if not (repo / "salve_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {repo} is not a checkout of the repository (no salve_tpu_torch)",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(repo))
    from salve_tpu_torch.device import resolve_device

    dev = resolve_device(None)
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    report = run(dev)
    for mode, r in report["runs"].items():
        log(f"throughput: {mode} mode {r['hyp_per_s']:.2f} hypotheses/s "
            f"({r['hypotheses']} hypotheses over {r['seconds']:.3f} s, one floor's banks included)")
    bd = report["breakdown"]
    log(f"throughput: warp mode per score batch {report['batch'] * 1e3 / bd['score_batch']:.2f} hypotheses/s; "
        f"the banks cost {bd['banks_per_floor']:.3f} ms once per floor")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "l2_bound_ms", "launches_direct", "shape")
    rows = [{kk: row.get(kk) for kk in keys} for row in report["kernels"].values()]
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
