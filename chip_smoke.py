"""Chip smoke: drive salve_tpu_torch's fused scoring path and Stage A on one
CUDA card.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's nvcc. Exits non-zero, printing no result, without a card or
outside a checkout of the repository.

Phases:
  1. build the three CUDA kernels from `salve_tpu_torch/csrc` (timed), and
     print how many blocks B1's cooperative launch takes;
  2. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes (4 synthetic 512x1024 panos; 501^2 renders, 1001^2
     warp banks, 32 hypotheses): B1 splat (ceiling and floor at 4x501^2 and
     4x1001^2, the 32x501^2 direct-mode batch, rows of N % 4 != 0 points,
     all points rejected, all in one cell, points on each image's first and
     last cell),
     B2 fill + mask (also 32x501^2,
     the direct-mode batch, an odd 3x37x53, all-empty and all-occupied
     images, and B2's quotient against IEEE division for every float
     numerator) and B3 shear warp through the ceiling+floor pair entry (8
     hypotheses in each rot90 branch, and bank rows outside the bank) must
     agree exactly;
  3. run `score_floor_hypotheses` at full width (ResNet-152 early-fusion
     verifier with seeded random weights, resize 234 / crop 224, bf16,
     batch 32): 2560 hypotheses in warp mode, then 1024 in direct mode, each
     with the launch counts zeroed just before and read just after (warp
     mode must launch B3 once a batch, for both surfaces); then a
     small-input check of the card's path against the port's plain CPU
     path, and the median ms of the warp-mode path's parts (banks, one
     score batch, the verifier alone);
  4. time each kernel (device time: a sleep kernel fills the queue ahead of
     each timed round), its plain version and (B1) the library call doing
     the same work (the grid fill and one scatter_reduce_ with rejected
     points sent to a sentinel cell), median of CUDA-event timings, beside
     the bound computed from this run's inputs; B1 at its three main-path
     shapes (4x1001^2, 4x501^2, 32x501^2), with its atomic bounds: accepted
     points over the atomicMax rate this card shows into an L2-resident
     grid of the same size and into the shared memory of a cluster of 16
     blocks; B2 at 4x1001^2 and 32x501^2; B3 per surface in each rot90 branch,
     and with the L2 flushed before each launch (outside the timed window),
     as the verifier leaves it between batches;
  5. Stage A on 8 procedural floors (version 11, a 4x4 grid: 12-17 panos):
     `align_floor_pairs_batched` on the card at the inferred width ratio must
     give the hypotheses, transform bytes included, of its CPU run and of
     the host per-pair path; the GT-mode exporter writes two buildings; the
     1000-iteration RANSAC Sim(3) alignment of one floor's poses (a known
     Sim(3), noise, outliers) on the card against its CPU run and the known
     transform; then the batched product's device ms per floor, and the
     whole call's ms per floor and hypotheses/s on the card and on the CPU.

The last three lines: the `kernels` JSON, the card's name and power limit,
and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import ctypes
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
# Cycles of the sleep kernel queued ahead of a timed round (about 6 ms).
SLEEP_CYCLES = 10_000_000
# Atomics of one L2-rate probe launch (csrc/splat.cu:salve_l2_atomic_probe).
PROBE_ATOMICS = 1 << 26
# int32 cells a block of the DSMEM-rate probe (csrc/splat.cu) holds: a 501^2
# grid over the 16 blocks of one cluster.
DSMEM_BLOCK_CELLS = 15_688
# Stage A's floors: procedural buildings of these seeds on a 4x4 grid, which
# reaches the generator's cap of 10 rooms a floor (12-17 panos).
STAGE_A_SEEDS = tuple(range(8))
STAGE_A_GRID = 4
RANSAC_ITERS = 1000
# Sleep ahead of a timed Stage A round (about 60 ms): longer than the host
# takes to enqueue the batched product's ~110 small kernels, so the events
# bracket device time only.
STAGE_A_SLEEP_CYCLES = 10 * SLEEP_CYCLES

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


def time_ms(fn, rounds: int = 5, per_round: int = 10, warmup: int = 2, prefill: bool = True,
            sleep_cycles: int = SLEEP_CYCLES) -> float:
    """Median over `rounds` of the mean ms of `per_round` back-to-back calls.

    CUDA events bracket each round. With `prefill`, each round first queues
    a sleep kernel of `sleep_cycles` (about 6 ms by default; outside the
    events), so the host enqueues the calls while the card waits and the
    events see the card's time alone, not the wrapper's Python, as long as
    the enqueue takes less than the sleep; without it a slow host can add
    gaps.
    """
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if prefill:
            torch.cuda._sleep(sleep_cycles)
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
    from salve_tpu_torch.ops.backproject import CEILING_Z_RANGE, FLOOR_Z_RANGE
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
    blocks = ctypes.c_int(0)
    kernels.check(lib.lib.salve_splat_max_blocks(ctypes.addressof(blocks)), "B1 blocks")
    report["b1_blocks"] = blocks.value
    log(f"phase 1: B1's cooperative launch: {blocks.value} blocks of 512 threads")

    # -- Phase 2: kernels against their plain versions ----------------------
    depths_np, rgbs_np = make_synthetic_pano_bank(n_panos, pano_h, pano_w, seed=0)
    depths = torch.as_tensor(depths_np.astype(np.float32), device=dev)
    rgbs = torch.as_tensor(rgbs_np, device=dev)
    xyz, c, v = surface_clouds(depths, rgbs, FLOOR_Z_RANGE, render_cfg)
    err = {"splat": 0.0, "fill": 0.0, "warp": 0.0}
    timing_inputs = {}
    rng = np.random.default_rng(1)
    # The direct-mode batch: 32 hypothesis clouds of pano 1 moved into the
    # partner's frame, as rendering/bev_pair.py:render_transformed_batched.
    xyz32, c32, v32 = direct_batch_clouds(rng, depths, rgbs, batch, render_cfg)
    b1_cases = []
    for zr, surface in ((CEILING_Z_RANGE, "ceiling"), (FLOOR_Z_RANGE, "floor")):
        for px in (img_px, bank_px):
            keys = splat_keys_at(bev, splat, *surface_clouds(depths, rgbs, zr, render_cfg), px,
                                 render_cfg.meters_per_px)
            b1_cases.append((f"{surface} {n_panos}x{px + 1}^2", keys, px + 1, px + 1))
            if surface == "floor":
                timing_inputs[f"splat {n_panos}x{px + 1}^2"] = (*keys, px + 1)
    keys = splat_keys_at(bev, splat, xyz32, c32, v32, img_px, render_cfg.meters_per_px)
    b1_cases.append((f"floor {batch}x{img_px + 1}^2 (direct-mode batch)", keys, img_px + 1, img_px + 1))
    timing_inputs[f"splat {batch}x{img_px + 1}^2"] = (*keys, img_px + 1)
    b1_cases += b1_edge_cases(np.random.default_rng(7), dev)
    for name, (cell, key, ok), h, w in b1_cases:
        got = splat.splat_priority_grid(cell, key, ok, h, w)
        ref = splat.splat_priority_grid_plain(cell, key, ok, h, w)
        e = max_abs_diff(got, ref)
        log(f"phase 2: B1 splat {name}, {cell.shape[1]} points a row: max |diff| {e}")
        if not torch.equal(got, ref):
            raise AssertionError(f"B1 splat disagrees with its plain version at {name}")
        err["splat"] = max(err["splat"], e)
        if name.startswith("all rejected") and not bool((got == -1).all()):
            raise AssertionError("B1 wrote a cell where no point was accepted")

    for px in (img_px, bank_px):
        side = px + 1
        sparse, occ, support = fill_inputs(bev, splat, xyz, c, v, px, render_cfg.meters_per_px)
        got = fill.fill_and_mask(sparse, occ, support)
        ref = fill.fill_and_mask_plain(sparse, occ, support)
        e = max_abs_diff(got, ref)
        log(f"phase 2: B2 fill {n_panos}x{side}^2: max |diff| {e}")
        if not torch.equal(got, ref):
            raise AssertionError("B2 fill+mask disagrees with its plain version")
        err["fill"] = max(err["fill"], e)
        timing_inputs[px] = (sparse, occ, support)

    timing_inputs["direct"] = fill_inputs(bev, splat, xyz32, c32, v32, img_px, render_cfg.meters_per_px)
    odd = {"3x37x53": random_fill_inputs(rng, 3, 37, 53, 0.05, dev),
           "empty 2x64x96": random_fill_inputs(rng, 2, 64, 96, 0.0, dev),
           "occupied 2x64x96": random_fill_inputs(rng, 2, 64, 96, 1.0, dev)}
    for name, args in [(f"{batch}x{img_px + 1}^2 (direct-mode batch)", timing_inputs["direct"]), *odd.items()]:
        got, ref = fill.fill_and_mask(*args), fill.fill_and_mask_plain(*args)
        e = max_abs_diff(got, ref)
        log(f"phase 2: B2 fill {name}: max |diff| {e}")
        if not torch.equal(got, ref):
            raise AssertionError(f"B2 fill+mask disagrees with its plain version at {name}")
        err["fill"] = max(err["fill"], e)
    mismatches = torch.zeros(1, dtype=torch.int64, device=dev)
    kernels.check(lib.lib.salve_fill_div_check(mismatches.data_ptr(), kernels.stream_handle()), "div check")
    log(f"phase 2: B2 quotient vs IEEE division, every finite float numerator from 2^-125 and den 2..9: "
        f"{int(mismatches)} mismatches")
    if int(mismatches):
        raise AssertionError("B2's quotient differs from IEEE division")

    banks = tuple(warp.pack_rgb888(
        warp.render_identity_bank_extended(depths, rgbs, zr, render_cfg, bank_px)
    ).contiguous() for zr in (CEILING_Z_RANGE, FLOOR_Z_RANGE))
    ext = banks[1]
    # 8 hypotheses in each rot90 branch; then two bank rows outside the bank.
    R, t, idx = random_hypotheses(rng, batch, n_panos, dev, branches=np.arange(batch) % 4)
    params = warp.shear_warp_params(R, t, ext.shape[1], img_px, render_cfg.meters_per_px)
    counts = torch.bincount(params.n.long(), minlength=4).tolist()
    if min(counts) < 8:
        raise AssertionError(f"rot90 branches {counts}: fewer than 8 hypotheses in one")
    idx_out = idx.clone()
    idx_out[:2] = torch.tensor([-1, n_panos], device=dev)
    for rows, what in ((idx, "bank rows"), (idx_out, "two rows outside the bank")):
        got = warp.warp_banks_auto(banks, R, t, img_px, render_cfg.meters_per_px, bank_idx=rows)
        for surface, g, bank in zip(("ceiling", "floor"), got, banks):
            ref = warp.shear_warp_plain(bank, rows, params)
            for n in range(4):
                sel = params.n == n
                e = max_abs_diff(g[sel], ref[sel])
                log(f"phase 2: B3 warp pair entry, {surface}, {what}, rot90^{n} ({int(sel.sum())} "
                    f"hypotheses, {ext.shape[1]}^2 -> {params.d}^2): max |diff| {e}")
                err["warp"] = max(err["warp"], e)
            if not torch.equal(g, ref):
                raise AssertionError(f"B3 pair entry disagrees with the plain version ({surface}, {what})")
        if rows is idx_out and got[0][:2].any():
            raise AssertionError("B3 read a row outside the bank")
    timing_inputs["warp"] = (banks, R, t, idx, params)

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
    n_batches = -(-N_WARP_HYPS // batch)
    if runs["warp"]["launches"]["warp"] != n_batches:
        raise AssertionError(f"warp mode launched B3 {runs['warp']['launches']['warp']} times "
                             f"for {n_batches} batches: not once a batch for both surfaces")
    # B1 is one launch a render: 4 banks a floor, plus 2 a batch in direct mode.
    for mode, want in (("warp", 4), ("direct", 2 + 2 * -(-N_DIRECT_HYPS // batch))):
        if runs[mode]["launches"]["splat"] != want:
            raise AssertionError(f"{mode} mode launched B1 {runs[mode]['launches']['splat']} times, not {want}")
    check_small_input(dev)
    report["breakdown"] = time_breakdown(model, cfg, render_cfg, depths, rgbs, hyps[:batch], dev)
    log("phase 3: warp mode, median ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in report["breakdown"].items()))

    # -- Phase 4: times beside bounds -----------------------------------------
    k = report["kernels"]
    # B1 at the main path's three shapes: the extended banks (the row's own
    # numbers), the identity banks and the direct-mode batch.
    dsmem = dsmem_atomic_rate(lib.lib)
    b1 = {name[len("splat "):]: splat_row(lib.lib, splat, *timing_inputs[name], dsmem, dev)
          for name in (f"splat {n_panos}x{bank_px + 1}^2", f"splat {n_panos}x{img_px + 1}^2",
                       f"splat {batch}x{img_px + 1}^2")}
    main_shape = f"{n_panos}x{bank_px + 1}^2"
    k["splat"] = {kk: b1[main_shape][kk] for kk in ("shape", "ms", "plain_ms", "library_ms", "bound_ms",
                                                    "bound_by", "l2_bound_ms", "dsmem_bound_ms")}
    k["splat"]["extra"] = {"by_shape": b1, "blocks": report["b1_blocks"]}

    def fill_row(args):
        cells = args[0].shape[0] * args[0].shape[1] * args[0].shape[2]
        f_bytes, f_ops = cells * 26 / HBM_BYTES_PER_S, cells * FILL_OPS_PER_CELL / FP32_OPS_PER_S
        return {
            "shape": "x".join(str(x) for x in args[0].shape),
            "ms": time_ms(lambda: fill.fill_and_mask(*args)),
            "plain_ms": time_ms(lambda: fill.fill_and_mask_plain(*args)),
            "library_ms": None,
            "bound_ms": max(f_bytes, f_ops) * 1e3,
            "bound_by": "bytes" if f_bytes >= f_ops else "operations",
        }

    k["fill"] = fill_row(timing_inputs[bank_px])
    k["fill"]["extra"] = {"direct_batch": fill_row(timing_inputs["direct"])}
    log(f"phase 4: fill at the direct-mode batch {k['fill']['extra']['direct_batch']}")

    # B3: one pair launch (ceiling + floor) as score_batch makes it; then per
    # surface in each rot90 branch, with the L2 warm and flushed.
    banks, R, t, idx, params = timing_inputs["warp"]
    mpp = render_cfg.meters_per_px
    k["warp"] = {
        "shape": f"2 banks x {batch} rows of {ext.shape[1]}^2 -> 2x{batch}x{params.d}^2x3",
        "ms": time_ms(lambda: warp.shear_warp_cuda(banks, idx, params)),
        "params_ms": time_ms(lambda: warp.shear_warp_params(R, t, ext.shape[1], img_px, mpp)),
        "plain_ms": time_ms(lambda: [warp.shear_warp_plain(bk, idx, params) for bk in banks]),
        "library_ms": None,
        "bound_ms": 2 * warp_bound_ms(warp, ext, idx, params),
        "bound_by": "bytes",
        "extra": warp_branch_times(warp, banks, img_px, mpp, rng, n_panos, dev),
    }
    for name, row in k.items():
        row.update(name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
                   launches=runs["warp"]["launches"][name],
                   launches_direct=runs["direct"]["launches"][name],
                   max_abs_err=err[name])
        log(f"phase 4: {name}: {row['ms']:.4f} ms (plain {row['plain_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}, library {row['library_ms']})")
    report["runs"] = runs

    # -- Phase 5: Stage A ------------------------------------------------------
    report["stage_a"] = stage_a_phase(dev)
    return report


def stage_a_floors():
    """(seed, building json, pano dict, pairs) of Stage A's procedural floors."""
    from salve_tpu_torch.common.pano_data import FloorData
    from salve_tpu_torch.dataset import procedural

    floors = []
    for seed in STAGE_A_SEEDS:
        building = procedural.generate_building_json(seed=seed, n_rows=STAGE_A_GRID, n_cols=STAGE_A_GRID, version=11)
        fd = FloorData.from_json(building["merger"]["floor_01"], "floor_01")
        pano_dict = {p.id: p for p in fd.panos}
        ids = sorted(pano_dict)
        floors.append((seed, building, pano_dict, [(i1, i2) for i1 in ids for i2 in ids if i1 < i2]))
    return floors


def hypothesis_key(h):
    """What a hypothesis carries, its transform as the bytes the exporter writes."""
    return (h.wdo_alignment_object, h.i1_wdo_idx, h.i2_wdo_idx, h.configuration,
            h.i2Ti1.rotation.tobytes(), h.i2Ti1.translation.tobytes(), h.i2Ti1.scale)


def host_clock_ms(fn, repeats: int = 3) -> float:
    """Median host-clock ms of `fn`; the card is idle at the start of each
    call, and `fn` ends in a device sync unless its enqueue alone is timed."""
    import torch

    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def stage_a_phase(dev) -> dict:
    """Stage A on the card: equality with the CPU and host paths, the GT-mode
    exporter, the RANSAC alignment, and times (module docstring, phase 5)."""
    import tempfile

    import numpy as np
    import torch

    from salve_tpu_torch import device as device_mod
    from salve_tpu_torch.hypotheses import batched, wdo_alignment
    from salve_tpu_torch.hypotheses.export import export_single_building_wdo_alignment_hypotheses

    cpu = torch.device("cpu")
    floors = stage_a_floors()
    device_mod.reset_launch_counts()
    out = {"floors": []}
    for seed, _, pano_dict, pairs in floors:
        got = batched.align_floor_pairs_batched(pano_dict, pairs, use_inferred_wdos_layout=True, device=dev)
        want = batched.align_floor_pairs_batched(pano_dict, pairs, use_inferred_wdos_layout=True, device=cpu)
        n_hyps = 0
        for i1, i2 in pairs:
            host, _ = wdo_alignment.align_rooms_by_wd(
                pano_dict[i1], pano_dict[i2], wdo_alignment.AlignTransformType.SE2, use_inferred_wdos_layout=True)
            card = [hypothesis_key(h) for h in got[(i1, i2)]]
            if card != [hypothesis_key(h) for h in want[(i1, i2)]]:
                raise AssertionError(f"Stage A floor {seed}, pair {(i1, i2)}: the card's hypotheses differ from the CPU's")
            if card != [hypothesis_key(h) for h in host]:
                raise AssertionError(f"Stage A floor {seed}, pair {(i1, i2)}: the card's hypotheses differ from the "
                                     "host per-pair path's")
            n_hyps += len(card)
        candidates = 0
        for obj_type in batched._TYPES:
            tables = batched.floor_tables(pano_dict, pairs, obj_type, dev)
            if tables is not None:
                b, w = tables[0].shape[:2]
                candidates += b * w * w * batched._NUM_CONFIGS[obj_type]
        row = {"seed": seed, "panos": len(pano_dict), "pairs": len(pairs), "candidates": candidates,
               "hypotheses": n_hyps}
        out["floors"].append(row)
        log(f"phase 5: Stage A floor {seed}: {row['panos']} panos, {row['pairs']} pairs, {candidates} candidates "
            f"(B*W*W*C), {n_hyps} hypotheses: the card's equal the CPU's and the host path's")
    out["launches"] = device_mod.launch_counts()
    log(f"phase 5: Stage A launches of B1-B3 (none on this path): {out['launches']}")

    repo = Path(__file__).resolve().parent
    (repo / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=repo / "build") as tmp:
        tmp = Path(tmp)
        for seed, building, _, _ in floors[:2]:
            bid = f"{seed:04d}"
            (tmp / "zind" / bid).mkdir(parents=True)
            (tmp / "zind" / bid / "zind_data.json").write_text(json.dumps(building))
            flags = export_single_building_wdo_alignment_hypotheses(
                str(tmp / "hyp"), bid, str(tmp / "zind" / bid / "zind_data.json"), str(tmp / "zind"),
                use_inferred_wdos_layout=False, device=dev)
            counts = {d.name: len(list(d.glob("*.json"))) for d in sorted((tmp / "hyp" / bid / "floor_01").iterdir())}
            if set(counts) != {"gt_alignment_exact", "gt_alignment_approx", "incorrect_alignment"}:
                raise AssertionError(f"exporter wrote {counts} for building {bid}")
            log(f"phase 5: exporter, GT mode, building {bid}: files {counts}, GT-valid share "
                f"{np.mean(flags['floor_01']):.3f}")
            out.setdefault("export", {})[bid] = counts

    out["ransac"] = ransac_check(dev, floors[0][2])
    out["times"] = stage_a_times(dev, floors)
    return out


def ransac_check(dev, pano_dict) -> dict:
    """RANSAC Sim(3) alignment of one floor's GT poses seen through a known
    Sim(3), with noise, 3 outliers and a missing pose, on the card and on
    the CPU; its device time and whole-call times."""
    import numpy as np
    import torch

    from salve_tpu_torch.algorithms import pose_alignment
    from salve_tpu_torch.geometry.poses import Pose3, Sim3

    rng = np.random.default_rng(11)
    ref = [None] * (max(pano_dict) + 1)
    for i, p in pano_dict.items():
        ref[i] = Pose3.from_rot2_trans2(p.global_Sim2_local.rotation.astype(np.float64),
                                        p.global_Sim2_local.translation.astype(np.float64))
    th = rng.uniform(-np.pi, np.pi)
    Rz = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])
    known = Sim3(Rz, np.array([*rng.uniform(-2, 2, 2), 0.0]), float(rng.uniform(0.5, 2.0)))
    est = []
    for p in ref:
        if p is None:
            est.append(None)
            continue
        dth = rng.normal(0, 0.01)
        Rn = np.array([[np.cos(dth), -np.sin(dth), 0], [np.sin(dth), np.cos(dth), 0], [0, 0, 1.0]])
        t = Rz.T @ (p.t / known.s - known.t) + np.array([*rng.normal(0, 0.01, 2), 0.0])
        est.append(Pose3(Rn @ Rz.T @ p.R, t))
    live = [i for i, p in enumerate(est) if p is not None]
    for i in rng.choice(live, 3, replace=False):
        est[i] = Pose3(est[i].R, est[i].t + np.array([*rng.uniform(-3, 3, 2), 0.0]))
    est[live[-1]] = None

    (aligned, aSb), (aligned_cpu, _) = (
        pose_alignment.ransac_align_poses_sim3_ignore_missing(ref, est, num_iters=RANSAC_ITERS, device=d)
        for d in (dev, torch.device("cpu")))
    pose_diff = max(max(np.abs(p.R - q.R).max(), np.abs(p.t - q.t).max())
                    for p, q in zip(aligned, aligned_cpu) if p is not None)
    rot_err_deg = float(np.rad2deg(np.arccos(np.clip((np.trace(aSb.R.T @ known.R) - 1) / 2, -1, 1))))
    row = {"pose_diff_card_cpu": float(pose_diff), "rot_err_deg": rot_err_deg,
           "scale_err": abs(aSb.s - known.s), "trans_err": float(np.abs(aSb.t - known.t).max())}
    log(f"phase 5: RANSAC ({RANSAC_ITERS} iterations, {len(live) - 1} poses, 3 outliers): card vs CPU largest pose "
        f"difference {pose_diff:.3e}; card vs the known Sim(3): rotation {rot_err_deg:.4f} deg, scale "
        f"{row['scale_err']:.4e}, translation {row['trans_err']:.4e}")
    if pose_diff > 1e-3 or rot_err_deg > 1.0 or row["scale_err"] > 0.02 * known.s:
        raise AssertionError(f"RANSAC alignment on the card is off: {row}")

    theta_a, ca, va = pose_alignment._planar_params(ref)
    theta_b, cb, vb = pose_alignment._planar_params(est)
    keep = pose_alignment.ransac_keep_masks(va & vb, RANSAC_ITERS, pose_alignment.DEFAULT_RANSAC_ALIGNMENT_DELETE_FRAC, 0)
    args = [pose_alignment._f32(x, dev) for x in (theta_a, ca, theta_b, cb, va & vb, keep)]
    row["errors_device_ms"] = time_ms(lambda: pose_alignment._ransac_errors(*args), rounds=7, per_round=1,
                                      sleep_cycles=STAGE_A_SLEEP_CYCLES)
    row["errors_enqueue_ms"] = host_clock_ms(lambda: pose_alignment._ransac_errors(*args), 5)
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        def call(d=d):
            pose_alignment.ransac_align_poses_sim3_ignore_missing(ref, est, num_iters=RANSAC_ITERS, device=d)
            torch.cuda.synchronize()
        row[f"whole_ms_{where}"] = host_clock_ms(call)
    log(f"phase 5: RANSAC times: batched fit+score device {row['errors_device_ms']:.4f} ms (host enqueue "
        f"{row['errors_enqueue_ms']:.3f} ms); whole call "
        f"(keep-mask draws, transfers, winner) card {row['whole_ms_card']:.3f} ms, CPU {row['whole_ms_cpu']:.3f} ms")
    return row


def stage_a_times(dev, floors) -> dict:
    """Per floor: the batched product's device ms on pre-packed tables (all
    three W/D/O types) and the host's time to enqueue it, and the host-clock
    ms of the whole
    `align_floor_pairs_batched` (packing, product, mask to the host, argwhere,
    float64 refits, records) on the card and on the CPU; with the part of the
    card's call up to the mask on the host, the rest being host work."""
    import torch

    from salve_tpu_torch.hypotheses import batched

    ratio = torch.tensor(batched.MIN_ALLOWED_INFERRED_WDO_WIDTH_RATIO, dtype=torch.float32, device=dev)
    rows = []
    for seed, _, pano_dict, pairs in floors:
        tables = {t: batched.floor_tables(pano_dict, pairs, t, dev) for t in batched._TYPES}
        tables = {t: tb for t, tb in tables.items() if tb is not None}

        def product():
            return [batched._product_se2_fits(*tb, ratio, batched._NUM_CONFIGS[t]) for t, tb in tables.items()]

        def to_mask():
            for t in batched._TYPES:
                tb = batched.floor_tables(pano_dict, pairs, t, dev)
                if tb is not None:
                    batched._product_se2_fits(*tb, ratio, batched._NUM_CONFIGS[t])[2].cpu()

        def whole(d):
            def fn():
                batched.align_floor_pairs_batched(pano_dict, pairs, use_inferred_wdos_layout=True, device=d)
                torch.cuda.synchronize()
            return fn

        n_hyps = sum(len(v) for v in batched.align_floor_pairs_batched(pano_dict, pairs, True, device=dev).values())
        row = {"seed": seed, "hypotheses": n_hyps,
               "product_device_ms": time_ms(product, rounds=7, per_round=1, sleep_cycles=STAGE_A_SLEEP_CYCLES),
               "product_enqueue_ms": host_clock_ms(product, 5),
               "to_mask_ms": host_clock_ms(to_mask, 5),
               "whole_ms_card": host_clock_ms(whole(dev), 5),
               "whole_ms_cpu": host_clock_ms(whole(torch.device("cpu")), 5)}
        rows.append(row)
        log(f"phase 5: Stage A floor {seed} times: product on the card {row['product_device_ms']:.4f} ms device, "
            f"{row['product_enqueue_ms']:.3f} ms host enqueue; "
            f"whole call card {row['whole_ms_card']:.3f} ms (to the mask on the host {row['to_mask_ms']:.3f} ms), "
            f"CPU {row['whole_ms_cpu']:.3f} ms; {n_hyps} hypotheses")
    n = sum(r["hypotheses"] for r in rows)
    summary = {
        "product_device_ms_median": statistics.median(r["product_device_ms"] for r in rows),
        "product_enqueue_ms_median": statistics.median(r["product_enqueue_ms"] for r in rows),
        "whole_ms_card_median": statistics.median(r["whole_ms_card"] for r in rows),
        "whole_ms_cpu_median": statistics.median(r["whole_ms_cpu"] for r in rows),
        "to_mask_ms_median": statistics.median(r["to_mask_ms"] for r in rows),
        "hyp_per_s_card": n / (sum(r["whole_ms_card"] for r in rows) * 1e-3),
        "hyp_per_s_cpu": n / (sum(r["whole_ms_cpu"] for r in rows) * 1e-3),
        "floors": rows,
    }
    log(f"phase 5: Stage A per floor (median of {len(rows)}): product {summary['product_device_ms_median']:.4f} ms "
        f"device, {summary['product_enqueue_ms_median']:.3f} ms host enqueue; whole call card {summary['whole_ms_card_median']:.3f} ms (to the mask "
        f"{summary['to_mask_ms_median']:.3f} ms), CPU {summary['whole_ms_cpu_median']:.3f} ms; "
        f"{summary['hyp_per_s_card']:.1f} hypotheses/s on the card, {summary['hyp_per_s_cpu']:.1f} on the CPU")
    return summary


def direct_batch_clouds(rng, depths, rgbs, n: int, render_cfg):
    """The floor clouds of a direct-mode batch: n random hypotheses' pano 1
    moved into the partner's frame (rendering/bev_pair.py:render_transformed_batched)."""
    import torch

    from salve_tpu_torch.ops.backproject import FLOOR_Z_RANGE
    from salve_tpu_torch.rendering.bev_pair import surface_clouds

    R, t, idx = random_hypotheses(rng, n, depths.shape[0], depths.device)
    xyz, c, v = surface_clouds(depths[idx], rgbs[idx], FLOOR_Z_RANGE, render_cfg)
    xt = R[:, None, 0, 0] * xyz[..., 0] + R[:, None, 0, 1] * xyz[..., 1] + 1.5 * t[:, None, 0]
    yt = R[:, None, 1, 0] * xyz[..., 0] + R[:, None, 1, 1] * xyz[..., 1] + 1.5 * t[:, None, 1]
    return torch.stack([xt, yt, xyz[..., 2]], dim=-1), c, v


def splat_keys_at(bev, splat, xyz, c, v, px: int, meters_per_px: float):
    """B1's (cell, key, ok) for clouds on a (px+1)^2 grid, as
    ops/bev.py:render_bev_images_batched makes them."""
    xy_img, z, _, valid = bev.splat_inputs(xyz, c, v, px, meters_per_px)
    return splat.splat_keys(xy_img, z, valid, px + 1, px + 1)


def b1_edge_cases(rng, dev) -> list:
    """(name, (cell, key, ok), h, w) of B1's edge inputs: rows of N % 4 != 0
    points (so groups of 4 straddle two images), every point rejected (the
    grid must come back all -1: no fill pass runs outside the kernel), every
    point in one cell, and points on each image's first and last cell."""
    import numpy as np
    import torch

    def t(cell, key, ok):
        return tuple(torch.as_tensor(np.ascontiguousarray(a), device=dev) for a in (cell, key, ok))

    b, h, w, n = 3, 37, 53, 1001
    hw = h * w
    cell = rng.integers(-3, hw + 3, (b, n)).astype(np.int32)
    key = rng.integers(0, 4 * n, (b, n)).astype(np.int32)
    ok = (rng.uniform(size=(b, n)) < 0.8) & (cell >= 0) & (cell < hw)  # rejected cells may lie outside
    ends = cell.copy()
    ends[:, :4], ends[:, -3:] = [0, hw - 1, 0, hw - 1], [hw - 1, 0, hw - 1]
    one = np.full((b, n), 1234, np.int32)
    m = 180_225
    return [
        ("3x37x53, N % 4 = 1", t(cell, key, ok), h, w),
        ("all rejected 3x37x53", t(cell, key, np.zeros_like(ok)), h, w),
        ("all rejected 4x501^2", t(np.zeros((4, m), np.int32), np.ones((4, m), np.int32), np.zeros((4, m), bool)),
         501, 501),
        ("one cell 3x37x53", t(one, key, np.ones_like(ok)), h, w),
        ("first and last cells 3x37x53", t(ends, key, (ends >= 0) & (ends < hw)), h, w),
    ]


def splat_row(lib, splat, cell, key, ok, side: int, dsmem: float, dev) -> dict:
    """B1 at one shape: its time, the plain and library times on the same
    inputs, and its byte, L2-atomic and DSMEM-atomic bounds (`dsmem`: the
    DSMEM atomicMax rate, a second)."""
    import torch

    b, n = cell.shape
    hw = side * side
    # The library call on equal work: the grid fill and one scatter_reduce_,
    # rejected points sent to a sentinel cell a row (inputs masked beforehand).
    lib_idx = torch.where(ok, cell.long(), torch.full_like(cell, hw, dtype=torch.long))
    lib_src = torch.where(ok, key, torch.full_like(key, -1))

    def library_splat():
        grid = torch.full((b, hw + 1), -1, dtype=torch.int32, device=dev)
        return grid.scatter_reduce_(1, lib_idx, lib_src, "amax", include_self=True)

    accepted = int(ok.sum())
    l2 = l2_atomic_rates(lib, b * hw, dev)
    row = {
        "shape": f"{b}x{n} points -> {b}x{side}^2 grid",
        "ms": time_ms(lambda: splat.splat_priority_grid(cell, key, ok, side, side)),
        "plain_ms": time_ms(lambda: splat.splat_priority_grid_plain(cell, key, ok, side, side)),
        "library_ms": time_ms(library_splat),
        "bound_ms": (b * n * 9 + b * hw * 4) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "accepted_points": accepted,
        "distinct_cells": int((splat.splat_priority_grid(cell, key, ok, side, side) >= 0).sum()),
        "l2_atomics_per_s": l2,
        "l2_bound_ms": accepted / max(l2.values()) * 1e3,
        "dsmem_atomics_per_s": dsmem,
        "dsmem_bound_ms": accepted / dsmem * 1e3,
    }
    log(f"phase 4: B1 {row['shape']}: {row['ms']:.4f} ms, plain {row['plain_ms']:.4f}, "
        f"library {row['library_ms']:.4f}, bound {row['bound_ms']:.4f}; {accepted} accepted points on "
        f"{row['distinct_cells']} cells: L2 atomicMax " + ", ".join(f"{p} {r:.4e}/s" for p, r in l2.items())
        + f" -> {row['l2_bound_ms']:.4f} ms, DSMEM atomicMax {dsmem:.4e}/s -> {row['dsmem_bound_ms']:.4f} ms")
    return row


def dsmem_atomic_rate(lib) -> float:
    """int32 atomicMax per second into the shared memory of clusters of 16
    blocks of DSMEM_BLOCK_CELLS cells (random block of the cluster, random
    cell), with as many clusters as the card holds at once."""
    from salve_tpu_torch.ops import kernels

    n = ctypes.c_int(0)
    per_thread = 256

    def probe():
        kernels.check(lib.salve_dsmem_atomic_probe(16, DSMEM_BLOCK_CELLS, per_thread, ctypes.addressof(n),
                                                   kernels.stream_handle()), "dsmem probe")

    ms = time_ms(probe)
    rate = n.value * 16 * 1024 * per_thread / (ms * 1e-3)
    log(f"phase 4: DSMEM atomicMax probe: {n.value} clusters of 16 blocks of {DSMEM_BLOCK_CELLS} cells, "
        f"{rate:.4e}/s")
    return rate


def random_hypotheses(rng, n: int, n_panos: int, dev, branches=None):
    """(R, t, bank rows) of n random hypotheses; `branches`, if given, holds
    the rot90 branch of the shear warp that each is to take (an angle within
    40 deg of that multiple of -90 deg)."""
    import numpy as np
    import torch

    th = rng.uniform(-np.pi, np.pi, n)
    if branches is not None:
        th = np.deg2rad(rng.uniform(-40, 40, n) - 90.0 * np.asarray(branches))
    R = np.stack([np.stack([np.cos(th), -np.sin(th)], -1), np.stack([np.sin(th), np.cos(th)], -1)], 1)
    return (torch.as_tensor(R.astype(np.float32), device=dev),
            torch.as_tensor(rng.uniform(-3, 3, (n, 2)).astype(np.float32), device=dev),
            torch.as_tensor(rng.integers(0, n_panos, n), device=dev))


def fill_inputs(bev, splat, xyz, c, v, px: int, meters_per_px: float):
    """B2's (sparse, occupied, support) for clouds on a (px+1)^2 grid, as
    ops/bev.py:render_bev_images_batched makes them."""
    import torch

    side = px + 1
    xy_img, z, rgb255, valid = bev.splat_inputs(xyz, c, v, px, meters_per_px)
    sparse, occ = splat.splat_zorder_batched(xy_img, z, rgb255, valid, side, side, quantize_u8=True)
    support = (torch.clamp(torch.round(sparse), 0, 255) > 0).all(dim=-1)
    return sparse.contiguous(), occ.contiguous(), support.contiguous()


def random_fill_inputs(rng, b: int, h: int, w: int, density: float, dev):
    """B2 inputs of u8 colours at a given share of occupied cells."""
    import numpy as np
    import torch

    hit = rng.uniform(size=(b, h, w, 1)) < density
    sparse = np.where(hit, rng.integers(0, 256, (b, h, w, 3)), 0).astype(np.float32)
    return (torch.as_tensor(sparse, device=dev), torch.as_tensor(hit[..., 0], device=dev),
            torch.as_tensor((sparse > 0).all(-1), device=dev))


def warp_bound_ms(warp, bank, idx, params) -> float:
    """B3's least time for one bank: its u8 output, the bank words this run's
    data reads (outputs whose pass chain lands in the source) and the
    parameters, over the HBM rate."""
    import torch

    n_reads = int((warp.shear_warp_plain(torch.ones_like(bank), idx, params)[..., 2] > 0).sum())
    b, d = idx.shape[0], params.d
    return (b * d * d * 3 + n_reads * 4 + b * (params.y2 + params.x3 + d + 2) * 4 + b * 8) / HBM_BYTES_PER_S * 1e3


def cold_l2_ms(fn, flush, n: int = 11) -> float:
    """Median ms of single calls of `fn`, each after `flush` (a buffer larger
    than the L2) was overwritten, outside the events; a short sleep kernel
    ahead of each call keeps the host out of the timed window."""
    import torch

    times = []
    for _ in range(n):
        flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES // 10)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def warp_branch_times(warp, banks, img_px: int, mpp: float, rng, n_panos: int, dev) -> dict:
    """B3 ms per surface for 32 hypotheses all in one rot90 branch: half a
    pair launch, one single-bank launch, and one single-bank launch with the
    L2 flushed just before it."""
    import torch

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)  # > the 50 MB L2
    out = {}
    for n in range(4):
        R, t, idx = random_hypotheses(rng, 32, n_panos, dev, branches=[n] * 32)
        params = warp.shear_warp_params(R, t, banks[0].shape[1], img_px, mpp)
        if not bool((params.n == n).all()):
            raise AssertionError(f"hypotheses meant for rot90^{n} took {params.n.tolist()}")
        row = {
            "pair_ms_per_surface": time_ms(lambda: warp.shear_warp_cuda(banks, idx, params)) / 2,
            "single_ms": time_ms(lambda: warp.shear_warp(banks[1], idx, params)),
            "single_cold_l2_ms": cold_l2_ms(lambda: warp.shear_warp(banks[1], idx, params), flush),
            "bound_ms": warp_bound_ms(warp, banks[1], idx, params),
        }
        out[f"rot90^{n}"] = row
        log(f"phase 4: warp rot90^{n}, per surface: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()))
    return out


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
            "banks_per_floor": time_ms(lambda: build_banks(depths, rgbs, render_cfg, True), prefill=False),
            "score_batch": time_ms(
                lambda: score_batch(model, cfg, render_cfg, True, *banks, i1, i2, R, t), prefill=False),
            "verifier_alone": time_ms(lambda: model(images), prefill=False),
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
    sa = report["stage_a"]["times"]
    log(f"throughput: Stage A {sa['hyp_per_s_card']:.2f} hypotheses/s on the card, {sa['hyp_per_s_cpu']:.2f} on "
        f"the CPU (align_floor_pairs_batched, host work included)")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "l2_bound_ms", "dsmem_bound_ms", "params_ms", "launches_direct",
            "shape",
            "extra")
    rows = [{kk: row.get(kk) for kk in keys} for row in report["kernels"].values()]
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
