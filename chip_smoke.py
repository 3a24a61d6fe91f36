"""Chip smoke: drive salve_tpu_torch's fused scoring path, Stage A, Stage D,
stitching, the corpus renderer, verifier training, monocular depth, the
end-to-end accuracy run, the evaluation CLIs, the mesh of ranks and the
single-image and single-pair renders, and the paper's inference chain
through the CLIs, on one CUDA card.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's nvcc. Exits non-zero, printing no result, without a card or
outside a checkout of the repository.

Phases:
  1. build the three CUDA kernels from `salve_tpu_torch/csrc` (timed), and
     print how many blocks B1's cooperative launch takes; the image IO
     (salve_tpu_torch/native, a JPEG codec written by hand and the PNG
     reader) on this machine's host: every committed JPEG and PNG fixture
     must decode to the sha256 of imageio's array, the encoder fixtures
     (seeded 501^2 render-like, 37x53 noise and 1024x2048 pano images, q95)
     must encode to the sha256 of cv2's bytes and the pano's bytes decode to
     Pillow's array; then the host ms of the pano's decode, of
     `load_pano_rgb` on it, of a 501^2 render's encode, and of a 512x1024
     u16 depth PNG of Average and Paeth rows, C unfilter against the plain
     one;
  2. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes (4 synthetic 512x1024 panos; 501^2 renders, 1001^2
     warp banks, 32 hypotheses): B1 splat (ceiling and floor at 4x501^2 and
     4x1001^2, the 32x501^2 direct-mode batch, rows of N % 4 != 0 points,
     all points rejected, all in one cell, points on each image's first and
     last cell),
     B2 fill + mask (also 32x501^2,
     the direct-mode batch, an odd 3x37x53, all-empty and all-occupied
     images, and B2's quotient against IEEE division for every float
     numerator), B3 shear warp through the ceiling+floor pair entry (8
     hypotheses in each rot90 branch, and bank rows outside the bank) and
     the layout raster (the layout cell's 32x501^2 batch of 537-607-vertex
     rooms with 0-9 W/D/Os, a corpus chunk of 64, rooms past one staged
     tile of vertices, more W/D/Os than the kernel stages, geometry off the
     image with degenerate segments, rooms of 0-4 vertices; each call one
     launch of the layout kernel and none other, through one upload's
     views) must agree exactly;
  3. run `score_floor_hypotheses` at full width (ResNet-152 early-fusion
     verifier with seeded random weights, resize 234 / crop 224, bf16,
     batch 32): 2560 hypotheses in warp mode, then 1024 in direct mode, each
     with the launch counts zeroed just before and read just after (warp
     mode must launch B3 once a batch, for both surfaces); then the layout
     verifier (ceiling + floor RGB + layout, six images, seeded weights) on
     256 hypotheses in warp mode with seeded rooms of 537-607 vertices and
     0-9 W/D/Os, which must launch the layout kernel once a floor (pano 2's
     bank) and once a batch (pano 1's rows) and B1-B3 as the RGB verifier
     does; then a small-input check of the card's path against the port's plain CPU
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
     as the verifier leaves it between batches; the layout raster at the
     layout cell's 32x501^2 batch beside its byte bound;
  5. Stage A on 8 procedural floors (version 11, a 4x4 grid: 12-17 panos):
     `align_floor_pairs_batched` on the card at the inferred width ratio must
     give the hypotheses, transform bytes included, of its CPU run and of
     the host per-pair path; the GT-mode exporter writes two buildings; the
     1000-iteration RANSAC Sim(3) alignment of one floor's poses (a known
     Sim(3), noise, outliers) on the card against its CPU run and the known
     transform; then the batched product's device ms per floor, and the
     whole call's ms per floor and hypotheses/s on the card and on the CPU;
  6. Stage D and the floor report on the first 4 of those floors: the GT-mode exporter
     and seeded predictions (oracle labels, 15% of the positives and every
     positive of one pano a floor below the 0.93 threshold, 3 confident false
     positives) feed `run_incremental_reconstruction` in the frozen
     configuration (pose2_slam, cluster rescue, no axis alignment, no
     predictions root) on the card and on the CPU: per floor the % localized,
     the top-2/3 component shares and the IoU must be equal, the pose errors
     within 1e-6 and the serialized poses within 1e-9; in a pass of its own
     on the card, each floor's LM call must return its input poses bit for
     bit (the reference defect; seen through the interpreter's profile hook,
     nothing of the port replaced); then one floor with
     landmark SLAM and axis alignment on seeded MHNet predictions
     (inferred-mode hypotheses), card against CPU; the LM alone on a
     perturbed 16-pose graph with a nonzero prior (it moves), card against
     CPU within 1e-9, and on a like graph with pose 0 at the identity (it
     must return its input bit for bit on both); B1-B3 launch 0 times; then,
     on the identity-prior graph, the LM's host enqueue ms, one iteration's
     device ms, one Jacobian's operator calls and the whole run's summed
     kernel ms (torch.profiler); `polygon_mask`'s device ms for one floor's
     rooms; and the whole call's ms per floor on the card and the CPU.
  7. stitching on phase 6's 4 floors and their serialized card poses, with
     layouts seeded from the true rooms (`dataset/seeded_stitching.py`,
     nonzero uncertainties) and, for floor 0, phase 6's seeded MHNet files:
     `stitch_building_layouts` and `stitch_clusters` (two clusters a floor,
     scored against a ZInD floor map) on the card and on the CPU must give
     the same room groups in the same order, every fused ring bit for bit
     and equal score.json values; B1-B3 launch 0 times; then, for floor 0,
     the grids and edge counts the raster saw (through the interpreter's
     profile hook) and the call's summed kernel ms (torch.profiler), and the
     whole calls' ms per floor on the card and the CPU.

  8. the file-contract corpus renderer (`rendering/dataset_renderer.py`)
     on phase 6's floors 0 and 1, written out as a ZInD raw directory
     (1024x2048 JPEG panos from the port's encoder, 512x1024 u16 depth
     PNGs): the warp arm (501^2 identity renders and 1001^2 banks on the
     card, host NN warp, batch 64) over every GT-mode pair of both floors,
     on the card and on the CPU, must give equal file trees (sha256 of every
     file), launching B1 and B2 4 times a floor and B3 never; a second call
     renders 0 pairs; the direct arm (batch 8) on 64 pairs of floor 0, card
     against CPU, one B1 and one B2 a batch and surface, its img2 files equal
     to the warp arm's; the layout modality on 8 pairs of floor 0 with
     phase 6's seeded MHNet files, card against CPU, launching the layout
     kernel and none of B1-B3; then pairs/s and the
     whole call's ms a floor on both, the `render/*` stage timers, and one
     batch of 64 through the host warp against the torch gather warp on the
     card, fetch included.

  9. verifier training on phase 8's warp-arm corpus (floor 0, 415 pairs,
     the train split; floor 1, 451 pairs, the val split, by
     `split_overrides`): two train steps at small width (ResNet-18,
     resize 72 / crop 64, batch 8, same initial weights and augmentation
     draws) on the card against the CPU: step 1 in float32 (the loss within
     1e-4, each gradient within 1e-3 of its tensor's largest magnitude,
     finite, zero on both sides or on neither), step 2 in float64 from the
     CPU's state after step 1 (the loss, each gradient relative to its
     tensor's largest magnitude, the running statistics and the following
     eval step's probabilities within 1e-9, every gradient nonzero, labels
     equal where the CPU's probability is clear of 0.5); the train split's
     tuple order over phase 8's card and CPU trees must be the sorted one
     (its digest and the files' are logged); then the released model's config
     (`salve_tpu_torch/configs/ceiling_floor_rgb.yaml`: ResNet-152,
     12-channel stem, resize 234 / crop 224, batch 256, bf16, Adam + poly
     LR) through `train()` for 2 epochs host-streamed (256 + 159 tuples a
     train epoch) and 2 epochs on the device corpus (one batch a split and
     epoch): finite losses, a best checkpoint whose reload gives the saved
     model's eval logits bit for bit, `evaluate` writing 2 batch files that
     cover the 451 val tuples in dataset order, and a loss that falls over
     10 steps on one fixed class-separable batch of 32 (fresh crops and flips
     each step, as tests/training/test_train_step.py:39), a corpus batch's
     10 steps logged beside it;
     B1-B3 launch 0 times; two runs of 2 train steps at batch 256 from one
     state, seed and batch under the training policy
     (`device.deterministic_algorithms`, which `train()` applies) must end
     with equal parameters, batch-norm statistics and Adam moments, bit for
     bit; then the train step's device ms at batch 256 (CUDA events) and
     tuples/s under the policy and without it, in turns, the host ms
     of one streamed batch's 1,024 decodes and resizes, the device corpus's
     gather ms, eval tuples/s, peak device memory, and the step's model
     FLOPs (from the layer shapes) as a share of the dense bf16 peak.
 10. monocular depth, pano JPEG -> depth net on the card -> u16 mm PNG
     cache -> the corpus renderer: (a) `cli/batch_hohonet_inference.py`
     with a seeded HoHoNet `.pth` (512x1024, float32, no TF32) over phase
     8's floor 0 (its 1024x2048 JPEG panos) into a fresh depth root: one
     PNG a pano; two panos card against CPU (within 1e-4 m, the u16 maps at
     most 1 mm apart on at most 0.1% of the pixels); the whole CLI's
     panos/s, one forward's device ms at batch 1, its model FLOPs against
     the float32 peak, peak memory; (b) PanoDepthNet: two small-width steps
     (ResNet-18, embed 64, 1 block, 64x128) card against CPU from one
     state, step 1 in float32 (loss within 1e-5 relative, gradients within
     2e-2 of each tensor's max, running statistics within 1e-5), step 2 in
     float64 from the CPU's state (1e-9, 1e-8, 1e-9); `cli/train_depth.py
     --synthetic_rgb` at full width (ResNet-50, embed 512, 4 blocks,
     512x1024, bf16, batch 4) for 4 steps on phase 6's floors 0-2 with
     `evaluate_depth` on floor 3; 10 steps on one fixed batch at full width
     (the loss must fall), the train step's device ms, images/s, FLOP share
     and peak memory (the step under the training policy and without it, in
     turns); a checkpoint that reloads to the saved model's depth
     bit for bit; two runs of 2 full-width steps from one state and batch
     (the depth step runs under the training policy) must end equal, bit
     for bit; B1-B3 launch 0 times in (a) and (b); (c) `render_pairs`,
     direct arm, on 8 pairs of floor 0 reading (a)'s depth root: one B1 and
     one B2 a batch and surface, and its files.
 11. the end-to-end accuracy run and the rest of the device code: (a)
     `cli/end_to_end_eval.py` at the harness's own defaults (ResNet-18,
     resize 128 / crop 112, batch 16, RGB ceiling + floor, pose2_slam, GT
     ray-cast depth, the warp corpus, `--calibrate_on_val`) on procedural
     stand-ins for its two fixture buildings (0000 train, 1210 eval, written
     by `write_procedural_buildings` at base seed 7), cut to 2 epochs (the
     harness runs 8) and 1 procedural val building: `end_to_end_eval.json`
     with salve_tpu's keys, a finite IoU and % localized for every held-out
     floor, B1 and B2 4 launches a floor and B3 none; the card's checkpoint
     evaluated on the CPU (probabilities within 1e-3, labels equal where the
     CPU's is clear of 0.5 by 1e-3) and `--stage_d_only` on the CPU from the
     card's predictions (equal rows, pose errors within 1e-6); the training
     stage again from the same seed (`train()` and `evaluate()` on the
     harness's corpus and config): every checkpoint entry and every
     held-out batch file equal to the harness's, bit for bit; the summary's
     rows, `timings_s` and the materializer's seconds a pano; (a') the
     materializer's provider branch over building 1210's panos with phase
     10's PanoDepthNet checkpoint in float32, two panos card against CPU (at
     most 1 mm apart on at most 0.1% of the pixels); (b) the semantic render
     of phase 3's 4 panos at 501^2 (card equals CPU, one B1, no B2),
     `choose_elevated_repeated_vals` on one pano's cloud (equal masks, one
     B1), `interp_dense_grid_from_sparse` (both `is_semantics`) and
     `remove_hallucinated_content` (card equals CPU); (c)
     `cli/register_depth_maps_icp.py` on two panos of one room of building
     1210, card against CPU within 1e-4 (rotation, Frobenius) and 1e-4 m,
     each scale's loop ms (CUDA events) and the CLI's seconds.
 12. the evaluation side of the paper: (a) `cli/eval_floorplan.py` (GT poses
     with seeded MHNet layouts, `dataset/seeded_predictions.py`) over phase
     6's floors of the train split on the card and the CPU: equal reports
     (IoU and % localized exactly, errors within 1e-6), ms a floor on both;
     the first floor's RANSAC Sim(3) and raster IoU kernels and summed
     device ms (torch.profiler); (b) `cli/evaluate_sfm_baseline.py` for
     OpenSfM and OpenMVG over `dataset/seeded_sfm.py`'s reconstructions of
     all 4 floors (a seeded Sim(3), 1 degree and 5 cm of noise a pano, 3 panos
     dropped), card against CPU (equal reports and `result_summaries`
     files), each floor's aligned errors under 3x and 5x the noise, and
     `analyze_algorithm_results`' summary; (c) `analyze_predictions`,
     `measure_acc_vs_overlap`, `sanity_check_gt_pose_graphs`,
     `compute_average_zind_stats` and `estimate_completion_percent` over
     phase 11's harness tree: each returns (exit 0) with its summary;
     B1-B3 launch 0 times.
 13. more than one rank (salve_tpu_torch/parallel): (a) a world of one over
     NCCL: `score_floor_hypotheses(mesh=make_mesh())` on phase 3's first
     512 (warp) and 256 (direct) hypotheses equals phase 3 bit for bit;
     `cli/test_fused.py --mesh_devices 1` over 96 hypotheses of floor 0000
     writes the bytes of the run without the flag; 2 ResNet-152 train steps
     at batch 256 (bf16, phase 9's start state, batch rows and draws) under
     the training policy through the mesh's step equal the one-card step's
     bit for bit; (b) a world of two over gloo, both ranks on the one card
     (NCCL refuses two ranks on one GPU): each rank scores its 16 rows of
     every batch, equal bit for bit to the one-card scorer at batch 16 over
     them, the gathered lists equal on both ranks and within the MESH_*
     bounds of (a) at batch 32 (B1-B3 launched on every rank); 2
     global-batch train steps (2 x 128) from (a)'s start state, both ranks'
     states equal, losses, running statistics and parameters within their
     bounds of (a); (c) B1 and B2 at one rank's 16x501^2 direct-mode batch
     and B3's pair launch at 2x16 rows in all four rot90 branches, each
     equal to its plain version, timed beside its bound; the phase's
     seconds.
 14. the single-image and single-pair renders and the figures' policy
     (utils/plotting.py), after printing whether matplotlib and PIL are
     installed: `render_bev_image` on phase 3's pano 0 for both surfaces at
     501^2, card equal to CPU bit for bit, one B1 and one B2 launch a call,
     then B1 and B2 at B = 1 timed beside their byte bounds (sleep kernel
     ahead of each round); `render_bev_pair` for one hypothesis and
     `render_bev_pairs_batch` for 16 pairs of phase 3's panos, each surface,
     equal to `render_bev_pairs_batch_device`'s rows and to the CPU bit for
     bit, one B1 and one B2 a call; `rasterize_room_layout_pair` on two panos
     of phase 6's floor 0000, card equal to CPU, two layout launches; the depth-map CLI's image
     function (`backprojected_bev_images`) on one of phase 8's panos, card
     equal to CPU, and the CLI: without matplotlib it raises
     `MatplotlibMissing` and writes no file, with it it writes a PNG that
     decodes; `run_sfm` on phase 6's floor 0000 with `plot_save_dir`: its
     reports, serialized poses and summary those of phase 6's card run,
     without matplotlib one warning and no figure, with it both report
     figures; `visualize_floorplans_side_by_side_baselines` on a seeded
     OpenSfM reconstruction of floor 0000 on the card (`main` with
     `--device cuda` where matplotlib is installed, else the CLI's
     computation), its report equal to the CPU's.

 15. the paper's inference chain through the port's CLIs, each called
     through `main(argv)` as a user calls it: (1) `export_alignment_hypotheses
     --wdo_source ground_truth` for phase 8's floor 0001 (held out of phase
     9's training) and phase 11's held-out building, card and CPU, equal
     files; (2) `batch_hohonet_inference` with phase 10's seeded `.pth`
     (512x1024, float32) over floor 0001's panos into a fresh depth cache,
     and on the CPU over two of them, the u16 maps within phase 10's bound
     (1 mm on at most 0.1% of the pixels); (3) `test_fused` with warp
     renders in three arms: (a) the released width (ResNet-152, 234 / 224,
     bf16, batch 32) with phase 9's checkpoint on phase 8's depth PNGs, (b)
     the same on (2)'s cache, (c) phase 11's ResNet-18 (128 / 112) on its
     held-out building and ground-truth depth: B1, B2 and B3 launch as phase
     3's rule predicts (B1 and B2 4 a floor, B3 once a batch), and the CPU
     (`python -m salve_tpu_torch.cli.test_fused --device cpu
     --use_warp_renders`, one process an arm beside the card's chain)
     scores each arm's first 32 hypotheses: the same pairs and labels,
     class-1 probabilities within 1e-2; (4) `run_incremental_reconstruction`
     on the card and the CPU from the card's batch files, arms (a) and (b)
     in the frozen configuration, (c) in the configuration the harness froze
     on its val building, compared as in phase 6; (5) for arm (c)
     `stitch_building_layouts` on the card's poses and layouts seeded from
     the building's rooms, card against CPU as in phase 7; then the
     chain's seconds stage by stage, each arm's % localized and IoU (arm
     (b)'s depth is a seeded HoHoNet's, so its numbers mean nothing until
     the released `ep60.pth` is in the repository).
 16. HorizonNet in the scorer through the CLI: a seeded building (a
     procedural floor of 1x2 rooms, random 512x1024 JPEG panos, u16 depth
     PNGs, seeded MHNet predictions) scored by `test_fused --modalities
     ceiling_rgb_texture floor_rgb_texture layout --horizonnet_ckpt` (a
     seeded HorizonNet `.pth` at 512x1024, a seeded six-image ResNet-152):
     every pano's boundary computed on the card (`horizon/panos`), as CUDA
     graph replays with none eager, `boundary/vertices` the rooms the
     card's boundaries make, one answer a hypothesis; the card's boundaries
     against the CPU's within 1e-2 rows.

The last three lines: the `kernels` JSON, the card's name and power limit,
and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import ctypes
import gc
import hashlib
import io
import json
import logging
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
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
# Phase 8: the corpus renderer on two of phase 6's floors (every pair in the
# warp arm), a prefix of floor 0's pairs in the direct arm and the layout
# modality.
CORPUS_FLOORS = ("0000", "0001")
CORPUS_DIRECT_PAIRS = 64
CORPUS_LAYOUT_PAIRS = 8
# Phase 9: training on phase 8's warp-arm corpus, floor 0 the train split and
# floor 1 the val split; the released model's config.
TRAIN_CONFIG = "salve_tpu_torch/configs/ceiling_floor_rgb.yaml"
TRAIN_SPLITS = {"0000": "train", "0001": "val"}
TRAIN_EPOCHS = 2
FIXED_BATCH = 32
FIXED_BATCH_STEPS = 10
FIXED_BATCH_MAX_ITER = 50
# Phase 10: monocular depth. HoHoNet over phase 8's floor 0 (seeded weights),
# two panos card against CPU; PanoDepthNet trained by the CLI for a few steps
# at batch 4 on phase 6's floors (the last one held out), ten steps on one
# fixed batch; the corpus renderer's direct arm on 8 pairs of HoHoNet's depth.
DEPTH_SEED = 0
DEPTH_CHECK_PANOS = 2
DEPTH_TRAIN_BATCH = 4
DEPTH_CLI_STEPS = 4
DEPTH_FIXED_STEPS = 10
DEPTH_RENDER_PAIRS = 8
# Sleep ahead of a timed depth forward (about 60 ms): the host enqueues a
# HoHoNet forward's ~600 kernels behind it.
DEPTH_SLEEP_CYCLES = 10 * SLEEP_CYCLES
# Dense bf16 tensor-core peak of an H100 SXM (NVIDIA data sheet) at 700 W.
BF16_FLOPS_PER_S = 989e12
# Floors of phases 6 and 7: the first 4 of Stage A's 8 (cut from 8 when
# phase 8 joined the run, to keep the whole run near its old length).
STAGE_D_FLOORS = 4
# Stage D's frozen configuration (salve_tpu/cli/end_to_end_eval.py:433-477).
STAGE_D_THRESHOLD = 0.93
STAGE_D_WDO_TYPES = ["door", "window", "opening"]
# Sleep ahead of a timed Stage A round (about 60 ms): longer than the host
# takes to enqueue the batched product's ~110 small kernels, so the events
# bracket device time only.
STAGE_A_SLEEP_CYCLES = 10 * SLEEP_CYCLES
# Phase 11: the end-to-end harness at its own defaults, on procedural
# stand-ins for its two fixture buildings (train 0000, eval 1210) written at
# base seed 7, one procedural val building, 2 epochs (the harness runs 8).
E2E_BUILDINGS = ("0000", "1210")
E2E_BASE_SEED = 7
E2E_VAL_BUILDINGS = 1
E2E_EPOCHS = 2
E2E_PROVIDER_CHECK_PANOS = 2
# Phase 12: the oracle-pose floorplan evaluation on phase 6's floors of the
# train split with seeded MHNet layouts, the SfM baselines on seeded
# reconstructions of all 4 floors, and the analysis CLIs on phase 11's tree.
EVAL_SPLIT = "train"
SFM_ALGORITHMS = ("opensfm", "openmvg")
# A floor's aligned errors against the injected noise (dataset/seeded_sfm.py:
# 1 degree and 5 cm a pano): mean rotation error under 3x, translation 5x.
SFM_ROT_BOUND = 3.0
SFM_TRANS_BOUND = 5.0
# The keys of salve_tpu's end_to_end_eval.json (salve_tpu/cli/end_to_end_eval.py:480-521).
E2E_SUMMARY_KEYS = sorted([
    "train_building", "eval_building", "eval_procedural_buildings", "verifier", "depth", "reconstruction",
    "reconstruction_summary", "method", "rescue_clusters", "glc", "rotfix", "confidence_threshold", "calibration",
    "warp_corpus", "timings_s", "total_wallclock_s"])
E2E_VERIFIER_KEYS = sorted([
    "precision", "recall", "mAcc", "per_building", "ckpt", "train_mAcc_last", "val_mAcc_best", "train_mAcc_history",
    "num_layers", "num_epochs", "modalities"])
E2E_REPORT_KEYS = sorted([
    "building_id", "floor_id", "avg_abs_rot_err_deg", "avg_abs_trans_err", "percent_panos_localized",
    "floorplan_iou", "percent_in_top2_ccs", "percent_in_top3_ccs"])
# Phase 13: more than one rank. The world of one (NCCL) and the world of two
# (gloo, both ranks on the one card) score phase 3's first hypotheses; the
# CLI scores a prefix of floor 0000's; train steps at the released batch.
MESH_SCORED = {"warp": 512, "direct": 256}
MESH_CLI_HYPS = 96
MESH_TRAIN_BATCH = 256
MESH_TRAIN_STEPS = 2
MESH_RANK_BATCH = 16
# The world of two against the world of one, in bf16 through ResNet-152:
# the class-1 probability within 2^-10 (each rank runs the one-card program
# at half the batch: cuDNN may pick other bf16 algorithms), labels equal
# where it is clear of 0.5 by that much; for the train steps the bf16 levels
# of tests/test_torch_training.py:test_bf16_bottleneck_step_matches_salve_tpu:
# losses within 2^-6 of their size, running statistics within 2^-5 of their
# tensor's largest magnitude; parameters within 4 lr (each Adam step moves a
# parameter by up to about lr, in either direction where its gradient is
# tiny).
MESH_PROB_BOUND = 2.0 ** -10
MESH_LOSS_BOUND = 2.0 ** -6
MESH_STATS_BOUND = 2.0 ** -5
MESH_PARAM_BOUND = 4e-3
# Phase 14: pairs of phase 3's panos in the host-array pair batch.
SINGLE_BATCH_PAIRS = 16
# Phase 15: the paper's inference chain through the port's CLIs on phase 8's
# floor 0001, which phase 9 holds out of training (TRAIN_SPLITS), and on
# phase 11's held-out building. The CPU runs HoHoNet on two panos and scores
# the first 32 hypotheses of each arm, one batch (ResNet-152 in bf16 is slow
# on the card machine's CPU: 64 would put the phase over its 60 s). The card
# renders pano 1 with B3's shear warp and the CPU with the exact gather,
# which differ on up to 5e-5 of the pixels (tests/parity/test_warp_drift.py),
# and both score in bf16, as the CLI builds the verifier: class-1
# probabilities within 1e-2 (on an H100 80GB HBM3 at 700 W, 7.165e-4 and
# 8.687e-4 through ResNet-152, 3.687e-3 through ResNet-18 at 112), labels
# equal where clear of 0.5 by it.
CHAIN_FLOOR = CORPUS_FLOORS[1]
CHAIN_CPU_HYPS = 32
CHAIN_PROB_BOUND = 1e-2

# Phase 3's layout verifier: hypotheses in warp mode (8 batches of 32).
N_LAYOUT_HYPS = 256
# Phase 16: a seeded building's floor scored through the CLI with HorizonNet
# computing each pano's boundary; the card's boundaries against the CPU's
# in rows (float32 both, other sums: the benchmark's card reads 3e-4-5e-4
# against its plain reference, TF32 0.36-0.41).
HORIZON_SEED = 16
HORIZON_ROWS_BOUND = 1e-2

REPLACES = {
    "splat": "salve_tpu/ops/pallas_splat.py:77",
    "fill": "salve_tpu/ops/pallas_fill.py:132",
    "warp": "salve_tpu/ops/pallas_warp.py:430",
    "layout": "salve_tpu/rendering/layout.py:137 (plain XLA, no Pallas kernel)",
}
SOURCES = {
    "splat": "salve_tpu_torch/csrc/splat.cu",
    "fill": "salve_tpu_torch/csrc/fill.cu",
    "warp": "salve_tpu_torch/csrc/warp.cu",
    "layout": "salve_tpu_torch/csrc/layout.cu",
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
    from salve_tpu_torch.pipeline import fused_inference
    from salve_tpu_torch.pipeline.fused_inference import score_floor_hypotheses
    from salve_tpu_torch.rendering import layout
    from salve_tpu_torch.rendering.bev_pair import BEVRenderConfig, render_identity_banks, surface_clouds
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
    report["image_io"] = image_io_phase()

    # -- Phase 2: kernels against their plain versions ----------------------
    depths_np, rgbs_np = make_synthetic_pano_bank(n_panos, pano_h, pano_w, seed=0)
    depths = torch.as_tensor(depths_np.astype(np.float32), device=dev)
    rgbs = torch.as_tensor(rgbs_np, device=dev)
    xyz, c, v = surface_clouds(depths, rgbs, FLOOR_Z_RANGE, render_cfg)
    err = {"splat": 0.0, "fill": 0.0, "warp": 0.0, "layout": 0.0}
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

    banks = tuple(render_identity_banks(depths, rgbs, zr, render_cfg, bank_px)[1]
                  for zr in (CEILING_Z_RANGE, FLOOR_Z_RANGE))
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

    # The layout kernel, one launch a call and no other kernel, against its
    # plain version.
    one_layout = {name: int(name == "layout") for name in device_mod.KERNELS}
    for name, case in layout_cases(np.random.default_rng(11)).items():
        inputs = layout_inputs(layout, case, dev)
        device_mod.reset_launch_counts()
        got = layout.rasterize_layout_batch_device(*inputs, img_px, render_cfg.meters_per_px)
        launched = device_mod.launch_counts()
        ref = layout.rasterize_layout_plain(*inputs, img_px, render_cfg.meters_per_px)
        differ = int((got != ref).sum())
        err["layout"] = max(err["layout"], max_abs_diff(got, ref))
        log(f"phase 2: layout {name}: {differ} bytes differ, launches {launched}")
        if not torch.equal(got, ref) or launched != one_layout:
            raise AssertionError(f"the layout kernel disagrees with its plain version at {name} (launches {launched})")
        timing_inputs.setdefault("layout", (case, inputs))

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

    runs, scored = {}, {}
    for mode, warp_on, hs in (("warp", True, hyps), ("direct", False, hyps[:N_DIRECT_HYPS])):
        # The measured run captures its banks' graph, so that it launches B1
        # and B2 itself rather than replay what the warm-up captured.
        fused_inference._BANK_GRAPHS.clear()
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
        scored[mode] = scored_rows(res)
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
    # B1 is one launch a render: 4 banks a floor in warp mode and 2 in direct
    # mode, each launched twice by the floor that captures the banks' graph
    # (an eager run, then the capture), plus 2 a batch in direct mode.
    for mode, want in (("warp", 2 * 4), ("direct", 2 * 2 + 2 * -(-N_DIRECT_HYPS // batch))):
        if runs[mode]["launches"]["splat"] != want:
            raise AssertionError(f"{mode} mode launched B1 {runs[mode]['launches']['splat']} times, not {want}")
        if runs[mode]["launches"]["layout"]:
            raise AssertionError(f"{mode} mode, with no layouts, launched the layout kernel")
    runs["layout"] = layout_verifier_run(dev, n_panos, depths_np, rgbs_np, hyps[:N_LAYOUT_HYPS], batch, render_cfg)
    lay_batches = -(-N_LAYOUT_HYPS // batch)
    want = dict(runs["warp"]["launches"], warp=lay_batches, layout=1 + lay_batches)
    if runs["layout"]["launches"] != want:
        raise AssertionError(f"the layout verifier launched {runs['layout']['launches']}, not {want}: the layout "
                             "kernel once a floor and once a batch, B1-B3 as the RGB verifier")
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

    k["fill"] = fill_row(fill, timing_inputs[bank_px])
    k["fill"]["extra"] = {"direct_batch": fill_row(fill, timing_inputs["direct"])}
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
    k["layout"] = layout_row(layout, *timing_inputs["layout"], img_px, mpp)
    for name, row in k.items():
        row.update(name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
                   launches=runs["layout" if name == "layout" else "warp"]["launches"][name],
                   launches_direct=runs["direct"]["launches"][name],
                   max_abs_err=err[name])
        log(f"phase 4: {name}: {row['ms']:.4f} ms (plain {row['plain_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}, library {row['library_ms']})")
    report["runs"] = runs

    # -- Phase 5: Stage A ------------------------------------------------------
    report["stage_a"] = stage_a_phase(dev)

    # -- Phases 6 and 7: Stage D and the report, then stitching on its poses ---
    repo = Path(__file__).resolve().parent
    (repo / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=repo / "build") as tmp:
        report["stage_d"] = stage_d_phase(dev, Path(tmp))
        report["stitching"] = stitching_phase(dev, Path(tmp))
        report["corpus"] = corpus_phase(dev, Path(tmp))
        del model
        gc.collect()
        torch.cuda.empty_cache()
        report["training"] = training_phase(dev, Path(tmp) / "corpus" / "warp_card", Path(tmp) / "training")
        report["depth"] = depth_phase(dev, Path(tmp))
        report["e2e"] = e2e_phase(dev, Path(tmp), Path(tmp) / "depth_net" / "fixed.pt")
        report["evaluation"] = evaluation_phase(dev, Path(tmp), Path(tmp) / "e2e")
        report["mesh"] = mesh_phase(dev, Path(tmp), Path(tmp) / "corpus" / "warp_card", scored, depths, rgbs, banks,
                                    render_cfg)
        report["single"] = single_render_phase(dev, Path(tmp), depths_np, rgbs_np, report["stage_d"])
        report["chain"] = chain_phase(dev, Path(tmp), sorted(Path(tmp).glob("training/streamed/*/train_ckpt.pt"))[-1],
                                      Path(tmp) / "hohonet" / "ep60_seeded.pth", Path(tmp) / "e2e")
        report["horizon"] = horizon_phase(dev, Path(tmp))
    for name, row in report["kernels"].items():
        row["launches_corpus"] = {arm: report["corpus"][f"{arm}_card"]["launches"][name] for arm in ("warp", "direct")}
        row["launches_depth"] = {"hohonet": report["depth"]["hohonet"]["launches"][name],
                                 "depth_net": report["depth"]["depth_net"]["launches"][name],
                                 "render": report["depth"]["render"]["launches"][name]}
        row["launches_e2e"] = {"harness": report["e2e"]["harness"]["launches"][name],
                               "semantic_render": report["e2e"]["semantics"]["render_launches"][name],
                               "zorder": report["e2e"]["semantics"]["zorder"]["launches"][name]}
        row["launches_mesh"] = {mode: [launches[name] for launches in report["mesh"]["b"][mode]["launches"]]
                                for mode in MESH_SCORED}
        row["extra"]["per_rank"] = report["mesh"]["kernels"].get(name)
        row["launches_single"] = {k: v[name] for k, v in report["single"]["launches"].items()}
        if name in report["single"]["kernels"]:
            row["extra"]["batch_1"] = report["single"]["kernels"][name]
        row["launches_chain"] = {arm: launches[name] for arm, launches in report["chain"]["launches"].items()}
    return report


def image_io_phase() -> dict:
    """Phase 1's image IO (salve_tpu_torch/native), on this machine's host:
    every committed JPEG and PNG fixture against the sha256 of imageio's
    array (recorded where imageio is), the encoder fixtures against the
    sha256 of cv2's bytes and the pano's decode against Pillow's array
    (native/fixtures/codec_sha256.json); any mismatch fails the run. Then
    the host ms (median of 3) of the codec at the corpus's sizes and of a
    512x1024 u16 depth-PNG read of Average and Paeth rows, through the C
    unfilter and the plain one."""
    import numpy as np

    from salve_tpu_torch.native import codec_fixtures as cf
    from salve_tpu_torch.native import jpeg, png
    from salve_tpu_torch.rendering import bev_pair

    fixtures = Path(jpeg.__file__).parent / "fixtures"
    record = json.loads((fixtures / "imageio_sha256.json").read_text())
    out = {}
    checked = []
    for name, want in sorted(record.items()):
        arr = (jpeg.decode_jpeg if name.endswith(".jpg") else png.read_png)(fixtures / name)
        got = {"shape": list(arr.shape), "dtype": str(arr.dtype), "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}
        if got != want:
            raise AssertionError(f"fixture {name}: {got} is not imageio's {want}")
        checked.append(name)
    out["fixtures_checked"] = checked
    log(f"phase 1: {len(checked)} committed fixtures ({sum(n.endswith('.jpg') for n in checked)} JPEG) decode to "
        f"imageio's arrays (sha256): {checked}")

    codec = cf.load_record()
    images = cf.encoder_images()
    encoded = {}
    for name, (img, q) in sorted(images.items()):
        encoded[name] = jpeg.encode_jpeg_bytes(img, q)
        if cf.sha256(encoded[name]) != codec["encode"][name]["sha256"]:
            raise AssertionError(f"encoder fixture {name}: the bytes are not cv2's")
    for name, want in codec["decode"].items():
        if cf.sha256(jpeg.decode_jpeg_bytes(encoded[name])) != want["sha256"]:
            raise AssertionError(f"decoder fixture {name}: the array is not Pillow's")
    out["codec_checked"] = sorted(codec["encode"]) + [f"decode:{n}" for n in codec["decode"]]
    log(f"phase 1: encoder bytes equal cv2's (sha256) for {sorted(codec['encode'])}; the decode of "
        f"{sorted(codec['decode'])} equals Pillow's array (record: {codec['versions']})")

    pano_bytes = encoded[cf.PANO_NAME]
    render = images["render_like_501x501"][0]
    with tempfile.TemporaryDirectory() as tmp:
        pano_path = Path(tmp) / "pano.jpg"
        pano_path.write_bytes(pano_bytes)
        for key, fn in (("pano_decode_ms", lambda: jpeg.decode_jpeg_bytes(pano_bytes)),
                        ("pano_load_pano_rgb_ms", lambda: bev_pair.load_pano_rgb(str(pano_path))),
                        ("render_encode_ms", lambda: jpeg.encode_jpeg_bytes(render, 95))):
            out[key] = host_clock_ms(fn)
    log(f"phase 1: codec host ms (median of 3): decode of the 1024x2048 q95 pano {out['pano_decode_ms']:.2f}, "
        f"load_pano_rgb on it (decode and resize to 512x1024) {out['pano_load_pano_rgb_ms']:.2f}, "
        f"encode of a 501^2 render at q95 {out['render_encode_ms']:.2f}")

    rng = np.random.default_rng(0)
    depth = (np.cumsum(np.cumsum(rng.integers(-2, 3, (512, 1024)), 0), 1) % 60000).astype(np.uint16)
    data = png.encode_png(depth, (3, 4))
    for key, plain in (("png_read_ms", False), ("png_read_plain_ms", True)):
        out[key] = host_clock_ms(lambda: png.decode_png_bytes(data, plain=plain))
        if not np.array_equal(png.decode_png_bytes(data, plain=plain), depth):
            raise AssertionError("the PNG reader did not return the depth map it was given")
    log(f"phase 1: 512x1024 u16 depth PNG of Average and Paeth rows, host ms (median of 3): C unfilter "
        f"{out['png_read_ms']:.2f}, plain unfilter {out['png_read_plain_ms']:.2f}")
    return out


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


def profiled_kernels(fn):
    """(kernels, summed device ms) of one call of `fn`, from torch.profiler;
    ms is None where CUPTI sees no kernel."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(kernels), (sum(getattr(e, "device_time_total", 0) for e in kernels) / 1e3 if kernels else None)


def state_bits(state) -> dict:
    """Every tensor a train state carries, cloned: parameters, batch-norm
    statistics and Adam's two moments."""
    names = [n for n, _ in state.model.named_parameters()]
    bits = {f"model/{k}": v.detach().clone() for k, v in state.model.state_dict().items()}
    for moment in ("mu", "nu"):
        bits.update({f"{moment}/{n}": t.detach().clone() for n, t in zip(names, getattr(state.optimizer, moment))})
    return bits


def repeat_check(what: str, state0, steps) -> dict:
    """Two runs of `steps(state) -> state` from copies of `state0` under the
    training policy (`device.deterministic_algorithms`, as `train()` and the
    depth step apply it): every tensor of the two end states must be equal
    bit for bit, and the steps must have moved the model."""
    import torch

    from salve_tpu_torch.device import deterministic_algorithms

    start = state_bits(state0)
    runs = []
    for _ in range(2):
        state = copy.deepcopy(state0)
        with deterministic_algorithms():
            state = steps(state)
        torch.cuda.synchronize()
        runs.append(state_bits(state))
        del state
    unequal = [k for k in runs[0] if not torch.equal(runs[0][k], runs[1][k])]
    moved = sum(not torch.equal(runs[0][k], start[k]) for k in start if k.startswith("model/"))
    row = {"tensors": len(start), "unequal": len(unequal), "moved_model_tensors": moved}
    log(f"{what}: two runs from one state, seed and batch under the deterministic policy: {len(start)} tensors "
        f"(parameters, batch-norm statistics, Adam moments), {len(unequal)} unequal; {moved} model tensors moved")
    if unequal or not moved:
        raise AssertionError(f"{what}: the two runs differ in {len(unequal)} tensors ({unequal[:6]}) or did not "
                             f"train ({moved} model tensors moved)")
    return row


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
        f"difference {pose_diff:.3e}, scorer outputs equal bit for bit; card vs the known Sim(3): rotation {rot_err_deg:.4f} deg, scale "
        f"{row['scale_err']:.4e}, translation {row['trans_err']:.4e}")
    if pose_diff > 1e-3 or rot_err_deg > 1.0 or row["scale_err"] > 0.02 * known.s:
        raise AssertionError(f"RANSAC alignment on the card is off: {row}")

    theta_a, ca, va = pose_alignment._planar_params(ref)
    theta_b, cb, vb = pose_alignment._planar_params(est)
    keep = pose_alignment.ransac_keep_masks(va & vb, RANSAC_ITERS, pose_alignment.DEFAULT_RANSAC_ALIGNMENT_DELETE_FRAC, 0)
    args = [pose_alignment._f32(x, dev) for x in (theta_a, ca, theta_b, cb, va & vb, keep)]
    # The scorer's float32 outputs: the card's bits are the CPU's.
    outs = [pose_alignment._ransac_errors(*a) for a in (args, [x.cpu() for x in args])]
    for name, x, y in zip(("mean_rot", "mean_trans", "theta", "t", "s"), *outs):
        if not torch.equal(x.cpu().view(torch.int32), y.view(torch.int32)):
            raise AssertionError(f"RANSAC scorer: {name} on the card differs from the CPU's")
    if pose_diff != 0.0:
        raise AssertionError(f"RANSAC: the card's aligned poses differ from the CPU's by {pose_diff}")
    # More kernels than the launch queue holds: device time as the summed
    # kernel time of one call (torch.profiler), enqueue on the host clock.
    row["errors_kernels"], row["errors_device_ms"] = profiled_kernels(lambda: pose_alignment._ransac_errors(*args))
    row["errors_enqueue_ms"] = host_clock_ms(lambda: pose_alignment._ransac_errors(*args), 5)
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        def call(d=d):
            pose_alignment.ransac_align_poses_sim3_ignore_missing(ref, est, num_iters=RANSAC_ITERS, device=d)
            torch.cuda.synchronize()
        row[f"whole_ms_{where}"] = host_clock_ms(call)
    log(f"phase 5: RANSAC times: batched fit+score {row['errors_kernels']} kernels, {row['errors_device_ms']:.4f} ms "
        f"summed device time (host enqueue "
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


def stage_d_inputs(root: Path, dev) -> dict:
    """Phase 6's inputs under `root`: the 4 floors' buildings, GT-mode
    hypotheses exported on the card and seeded predictions, one directory of
    predictions a floor; and floor 0 again with seeded MHNet predictions,
    vanishing angles and inferred-mode hypotheses."""
    from salve_tpu_torch.dataset import seeded_predictions as sp
    from salve_tpu_torch.hypotheses.export import export_single_building_wdo_alignment_hypotheses

    floors = {}
    for seed, building, _, _ in stage_a_floors()[:STAGE_D_FLOORS]:
        bid = f"{seed:04d}"
        (root / "zind" / bid).mkdir(parents=True)
        annot = root / "zind" / bid / "zind_data.json"
        annot.write_text(json.dumps(building))
        export_single_building_wdo_alignment_hypotheses(str(root / "hyp"), bid, str(annot), str(root / "zind"),
                                                        use_inferred_wdos_layout=False, device=dev)
        sp.write_seeded_predictions(str(root / "hyp"), bid, sp.pano_image_paths(building),
                                    str(root / "preds" / bid), seed=seed)
        floors[bid] = building
    bid, building = "0000", floors["0000"]
    sp.write_seeded_mhnet_predictions(root / "mhnet", bid, building, 0)
    sp.write_seeded_vanishing_angles(root / "mhnet", bid, building, 0)
    export_single_building_wdo_alignment_hypotheses(
        str(root / "hyp_inferred"), bid, str(root / "zind" / bid / "zind_data.json"), str(root / "zind"),
        use_inferred_wdos_layout=True, mhnet_predictions_data_root=str(root / "mhnet"), device=dev)
    sp.write_seeded_predictions(str(root / "hyp_inferred"), bid, sp.pano_image_paths(building),
                                str(root / "preds_inferred"), seed=0)
    return floors


def compare_stage_d_runs(what: str, card, cpu, card_dir: Path, cpu_dir: Path) -> dict:
    """Card against CPU for one `run_incremental_reconstruction` call: the
    reports (equal, errors within 1e-6) and the serialized poses (1e-9)."""
    import numpy as np

    if len(card) != len(cpu) or not card:
        raise AssertionError(f"{what}: {len(card)} reports on the card, {len(cpu)} on the CPU")

    def same(x, y) -> bool:  # a floor without edges reports NaN errors and shares
        return x == y or (x != x and y != y)

    worst = {"errors": 0.0, "poses": 0.0}
    for a, b in zip(card, cpu):
        for k in ("building_id", "floor_id", "percent_panos_localized", "percent_in_top2_ccs",
                  "percent_in_top3_ccs", "floorplan_iou"):
            if not same(getattr(a, k), getattr(b, k)):
                raise AssertionError(f"{what}: {k} is {getattr(a, k)} on the card, {getattr(b, k)} on the CPU")
        pairs = [(a.avg_abs_rot_err, b.avg_abs_rot_err), (a.avg_abs_trans_err, b.avg_abs_trans_err)]
        if a.rotation_errors is not None or b.rotation_errors is not None:
            pairs += [(a.rotation_errors, b.rotation_errors), (a.translation_errors, b.translation_errors)]
        for x, y in pairs:
            x, y = np.asarray(x, dtype=np.float64), np.asarray(y, dtype=np.float64)
            if x.shape != y.shape or not np.array_equal(np.isnan(x), np.isnan(y)):
                raise AssertionError(f"{what}: floor {a.building_id}: pose errors {x} on the card, {y} on the CPU")
            if x.size and not np.isnan(x).all():
                worst["errors"] = max(worst["errors"], float(np.nanmax(np.abs(x - y))))
    files = sorted(p.name for p in card_dir.glob("*.json"))
    localized = any(r.percent_panos_localized > 0 for r in card)
    if (localized and not files) or files != sorted(p.name for p in cpu_dir.glob("*.json")):
        raise AssertionError(f"{what}: serialized poses {files} differ in their files")
    for name in files:
        a, b = (json.loads((d / name).read_text())["wSi_dict"] for d in (card_dir, cpu_dir))
        if a.keys() != b.keys():
            raise AssertionError(f"{what}: {name} holds other panos on the card")
        for i in a:
            for key in ("R", "t", "s"):
                worst["poses"] = max(worst["poses"], float(np.max(np.abs(np.subtract(a[i][key], b[i][key])))))
    if worst["errors"] > 1e-6 or worst["poses"] > 1e-9:
        raise AssertionError(f"{what}: card and CPU differ: {worst}")
    return worst


def moving_lm_graph(seed: int = 3, n: int = 16):
    """A floor-sized pose graph whose LM moves: measured relative poses from
    true ones with noise, every initial pose (the prior's too) perturbed."""
    import numpy as np

    from salve_tpu_torch.algorithms.pose2_slam import OdometryMeasurement
    from salve_tpu_torch.geometry.pose2 import Pose2

    rng = np.random.default_rng(seed)
    true = np.concatenate([rng.uniform(-8, 8, (n, 2)), rng.uniform(-np.pi, np.pi, (n, 1))], 1)
    odo = []
    for i1 in range(n):
        for i2 in range(i1 + 1, n):
            if rng.uniform() < 0.5:
                rel = Pose2(*true[i2]).between(Pose2(*true[i1]))
                odo.append(OdometryMeasurement(i1, i2, Pose2(rel.x + rng.normal(0, 0.02), rel.y + rng.normal(0, 0.02),
                                                             rel.theta + rng.normal(0, 0.01))))
    init = true + np.concatenate([rng.normal(0, 0.2, (n, 2)), rng.normal(0, 0.05, (n, 1))], 1)
    return [Pose2(*p) for p in init], odo


def lm_calls_of(fn) -> list:
    """Run fn() and return (initial poses, result) of each `planar_slam`
    call in it, as the interpreter's profile hook sees them return; nothing
    of the port is replaced."""
    from salve_tpu_torch.algorithms import pose2_slam

    code, calls = pose2_slam.planar_slam.__code__, []

    def hook(frame, event, arg):
        if event == "return" and frame.f_code is code:
            calls.append((frame.f_locals["wTi_list_init"], arg))

    sys.setprofile(hook)
    try:
        fn()
    finally:
        sys.setprofile(None)
    return calls


def identity_prior_graph(seed: int = 4, n: int = 16):
    """A moving_lm_graph with pose 0 at the identity, as the spanning tree puts
    its origin: the prior's residual is exactly 0, so (as in salve_tpu) every
    LM step is NaN and rejected, and the LM returns its input."""
    from salve_tpu_torch.geometry.pose2 import Pose2

    init, odo = moving_lm_graph(seed, n)
    return [Pose2(0.0, 0.0, 0.0)] + init[1:], odo


def lm_times(dev, graph) -> dict:
    """The LM on one factor graph: its host enqueue ms (host clock, no sync:
    the loop never waits for the card); the device ms of one iteration
    (`lm_step`), CUDA events behind a sleep kernel longer than its enqueue,
    median of 5 (a whole run launches more kernels than the card's launch
    queue holds, so behind a sleep the host would block and the events would
    see the host again); the operator calls of one Jacobian; and the
    kernels' summed device time in one whole run, from torch.profiler."""
    import torch

    from salve_tpu_torch.algorithms import pose2_slam

    tables, _, _ = pose2_slam.factor_tables(*graph, dev)
    pose2_slam.lm_solve(*tables, True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pose2_slam.lm_solve(*tables, True)
    enqueue = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    prob, start = pose2_slam.lm_start(*tables, True)
    one = time_ms(lambda: pose2_slam.lm_step(prob, *start), rounds=5, per_round=1,
                  sleep_cycles=STAGE_A_SLEEP_CYCLES)
    row = {"enqueue_ms": enqueue, "one_iteration_device_ms": one, "iterations": pose2_slam.MAX_LM_ITERS,
           "poses": tables[0].shape[0], "between_factors": tables[2].shape[0], "landmark_factors": tables[4].shape[0]}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        prob.jacobian(start[0])
        torch.cuda.synchronize()
    row["jacobian_operator_calls"] = sum(e.count for e in prof.key_averages())
    row["kernels"], row["kernel_ms"] = profiled_kernels(lambda: pose2_slam.lm_solve(*tables, True))
    return row


def stage_d_phase(dev, root: Path) -> dict:
    """Stage D on the card against the CPU, and times (module docstring,
    phase 6); its inputs and outputs stay under `root` for phase 7."""
    import numpy as np
    import torch

    from salve_tpu_torch import device as device_mod
    from salve_tpu_torch.algorithms import pose2_slam
    from salve_tpu_torch.cli.run_sfm import run_incremental_reconstruction
    from salve_tpu_torch.common import floor_reconstruction_report as fr
    from salve_tpu_torch.common.posegraph2d import get_gt_pose_graph
    from salve_tpu_torch.dataset.seeded_predictions import pano_image_paths
    from salve_tpu_torch.ops.raster import polygon_mask
    from salve_tpu_torch.utils import profiler

    cpu = torch.device("cpu")
    out = {}
    device_mod.reset_launch_counts()
    t0 = time.perf_counter()
    floors = stage_d_inputs(root, dev)
    log(f"phase 6: inputs for {len(floors)} floors (exporter on the card, seeded predictions) in "
        f"{time.perf_counter() - t0:.1f} s")

    def run(bid, d, tag, method="pose2_slam", **kw):
        kw.setdefault("hypotheses_save_root", str(root / "hyp"))
        kw.setdefault("serialized_preds_json_dir", str(root / "preds" / bid))
        kw.setdefault("use_axis_alignment", False)
        kw.setdefault("predictions_data_root", None)
        plot_dir = root / "out" / f"{tag}_{bid}_{d.type}"
        t = time.perf_counter()
        reports = run_incremental_reconstruction(
            raw_dataset_dir=str(root / "zind"), method=method, confidence_threshold=STAGE_D_THRESHOLD,
            allowed_wdo_types=STAGE_D_WDO_TYPES, plot_save_dir=str(plot_dir), rescue_clusters=True,
            device=d, **kw)
        if d.type == "cuda":
            torch.cuda.synchronize()
        return reports, (time.perf_counter() - t) * 1e3, Path(f"{plot_dir}_serialized")

    run("0000", dev, "warmup")
    rows, stage_times = [], {}
    for side, d in (("card", dev), ("cpu", cpu)):
        profiler.reset_stage_timers()
        for bid in floors:
            reports, ms, ser = run(bid, d, f"frozen_{side}")
            rows.append({"floor": bid, "side": side, "ms": ms, "reports": reports, "dir": ser})
        stage_times[side] = profiler.stage_summary()
    # The LM adds nothing to the spanning tree (the reference defect): on
    # the card, in a pass of its own, each floor's LM call returns its
    # input poses bit for bit.
    for bid in floors:
        calls = lm_calls_of(lambda: run(bid, dev, "lm_check"))
        if len(calls) != 1:
            raise AssertionError(f"floor {bid}: {len(calls)} LM calls")
        (init, (poses, _)), = calls
        if [tuple(p) if p else None for p in poses] != [tuple(p) if p else None for p in init]:
            raise AssertionError(f"floor {bid}: the LM on the card moved a spanning-tree pose")
    out["floors"] = []
    for bid in floors:
        card, host = (next(r for r in rows if r["floor"] == bid and r["side"] == t) for t in ("card", "cpu"))
        worst = compare_stage_d_runs(f"floor {bid}", card["reports"], host["reports"], card["dir"], host["dir"])
        r = card["reports"][0]
        row = {"floor": bid, "panos": len(pano_image_paths(floors[bid])),
               "localized_pct": r.percent_panos_localized, "top2_pct": r.percent_in_top2_ccs,
               "top3_pct": r.percent_in_top3_ccs, "iou": r.floorplan_iou, "rot_err_deg": r.avg_abs_rot_err,
               "trans_err_m": r.avg_abs_trans_err, "ms_card": card["ms"], "ms_cpu": host["ms"],
               "worst_error_diff": worst["errors"], "worst_pose_diff": worst["poses"]}
        out["floors"].append(row)
        log(f"phase 6: Stage D floor {bid}, {row['panos']} panos (frozen configuration): localized {r.percent_panos_localized:.2f}%, "
            f"top-2/3 CCs {r.percent_in_top2_ccs:.2f}/{r.percent_in_top3_ccs:.2f}%, IoU {r.floorplan_iou:.6f}, "
            f"rot {r.avg_abs_rot_err:.6f} deg, trans {r.avg_abs_trans_err:.6f} m; card = CPU (errors within "
            f"{worst['errors']:.1e}, poses within {worst['poses']:.1e}); the LM returned the spanning-tree poses; "
            f"whole call {card['ms']:.1f} ms card, {host['ms']:.1f} ms CPU")
    out["stage_times"] = stage_times
    log("phase 6: stage totals, card: " + ", ".join(f"{k} {v['total_s'] * 1e3:.1f} ms" for k, v in
                                                     stage_times["card"].items())
        + "; CPU: " + ", ".join(f"{k} {v['total_s'] * 1e3:.1f} ms" for k, v in stage_times["cpu"].items()))

    # Landmark SLAM with axis alignment on floor 0's inferred-mode inputs.
    kw = dict(hypotheses_save_root=str(root / "hyp_inferred"),
              serialized_preds_json_dir=str(root / "preds_inferred"), use_axis_alignment=True,
              predictions_data_root=str(root / "mhnet"))
    (card, ms_card, dir_card), (host, ms_cpu, dir_cpu) = (
        run("0000", d, f"landmarks_{side}", **kw) for side, d in (("card", dev), ("cpu", cpu)))
    worst = compare_stage_d_runs("landmark SLAM", card, host, dir_card, dir_cpu)
    out["landmarks"] = {"ms_card": ms_card, "ms_cpu": ms_cpu, "iou": card[0].floorplan_iou, **worst}
    log(f"phase 6: landmark SLAM + axis alignment, floor 0000: IoU {card[0].floorplan_iou:.6f}, localized "
        f"{card[0].percent_panos_localized:.2f}%; card = CPU (errors within {worst['errors']:.1e}, poses within "
        f"{worst['poses']:.1e}); whole call {ms_card:.1f} ms card, {ms_cpu:.1f} ms CPU")

    # The LM alone on a graph where it moves.
    init, odo = moving_lm_graph()
    (got, _), (want, _) = (pose2_slam.planar_slam(init, odo, {}, [], True, device=d) for d in (dev, cpu))
    diff = float(np.max(np.abs(np.array(got) - np.array(want))))
    moved = float(np.max(np.abs(np.array(got) - np.array(init))))
    out["moving_lm"] = {"max_diff_card_cpu": diff, "max_move": moved}
    log(f"phase 6: LM alone, {len(init)} poses, {len(odo)} between factors, nonzero prior: moved up to "
        f"{moved:.4f}; card vs CPU max |diff| {diff:.3e}")
    if diff > 1e-9 or moved < 0.05:
        raise AssertionError(f"the moving LM: card vs CPU {diff}, moved {moved}")

    init, odo = identity_prior_graph()
    for d in (dev, cpu):
        got, _ = pose2_slam.planar_slam(init, odo, {}, [], True, device=d)
        if [tuple(p) for p in got] != [tuple(p) for p in init]:
            raise AssertionError(f"the LM on the {d.type} moved a pose of an identity-prior graph")
    log(f"phase 6: LM on an identity-prior graph ({len(init)} poses, {len(odo)} between factors): returns its "
        f"input bit for bit on the card and the CPU, as salve_tpu's")

    out["launches"] = device_mod.launch_counts()
    log(f"phase 6: Stage D launches of B1-B3 (none on this path): {out['launches']}")
    if any(out["launches"].values()):
        raise AssertionError(f"Stage D launched a kernel of the scoring path: {out['launches']}")

    # Times on the card's clock.
    gt0 = get_gt_pose_graph("0000", "floor_01", str(root / "zind"))
    t = out["lm_floor"] = lm_times(dev, (init, odo, {}, [], True))
    log(f"phase 6: LM on the identity-prior graph ({t['poses']} poses, {t['between_factors']} between factors, "
        f"{t['iterations']} iterations): {t['enqueue_ms']:.3f} ms host enqueue; one iteration "
        f"{t['one_iteration_device_ms']:.4f} ms device; one Jacobian {t['jacobian_operator_calls']} operator calls; "
        f"torch.profiler: {t['kernels']} kernels, {t['kernel_ms']} ms of kernel time in the whole run")
    half_m = (500 / 2) * fr.IOU_EVAL_METERS_PER_PX
    rooms = [(p.room_vertices_global_2d * gt0.scale_meters_per_coordinate + half_m) / fr.IOU_EVAL_METERS_PER_PX
             for p in gt0.nodes.values()]
    v = np.zeros((len(rooms), 64, 2), np.float32)
    for k, img in enumerate(rooms):
        v[k, : len(img)] = img
    counts = np.array([len(r) for r in rooms])
    vt = torch.as_tensor(v, device=dev)
    if not torch.equal(polygon_mask(vt, counts, 501, 501).cpu(), polygon_mask(vt.cpu(), counts, 501, 501)):
        raise AssertionError("polygon_mask on the card differs from the CPU's")
    out["polygon_mask_ms"] = time_ms(lambda: polygon_mask(vt, counts, 501, 501))
    log(f"phase 6: polygon_mask, floor 0000's {len(rooms)} rooms at 501^2 (max {counts.max()} vertices): "
        f"{out['polygon_mask_ms']:.4f} ms device; card = CPU")
    out["ms_card_median"] = statistics.median(r["ms_card"] for r in out["floors"])
    out["ms_cpu_median"] = statistics.median(r["ms_cpu"] for r in out["floors"])
    log(f"phase 6: Stage D per floor (median of {len(out['floors'])}): whole call {out['ms_card_median']:.1f} ms "
        f"on the card, {out['ms_cpu_median']:.1f} ms on the CPU")
    return out


def raster_calls_of(fn) -> list:
    """Run fn() and return (edges, nx, ny) of each `points_in_polygon_grid`
    call in it, as the interpreter's profile hook sees them start; nothing
    of the port is replaced."""
    from salve_tpu_torch.ops import raster

    code, calls = raster.points_in_polygon_grid.__code__, []

    def hook(frame, event, arg):
        if event == "call" and frame.f_code is code:
            loc = frame.f_locals
            calls.append((int(loc["polygon"].shape[0]), len(loc["xs"]), len(loc["ys"])))

    sys.setprofile(hook)
    try:
        fn()
    finally:
        sys.setprofile(None)
    return calls


def fused_key(floor_shape_final) -> list:
    """Every fused boundary, confidence and pose of `refine_predicted_shape`,
    as exact floats (the room groups are its outer lists)."""
    return [[([(p.x, p.y) for p in xys], list(conf), (pose.position.x, pose.position.y, pose.rotation))
             for xys, conf, pose in group] for group in floor_shape_final]


def stitching_phase(dev, root: Path) -> dict:
    """Phase 7: stitching on phase 6's floors (module docstring)."""
    import numpy as np
    import torch

    from salve_tpu_torch import device as device_mod
    from salve_tpu_torch.algorithms.room_merging import group_panos_by_room
    from salve_tpu_torch.cli.stitch_floor_plan import stitch_building_layouts
    from salve_tpu_torch.dataset import seeded_stitching
    from salve_tpu_torch.dataset.salve_sfm_result_loader import EstimatedBoundaryType, load_estimated_pose_graph
    from salve_tpu_torch.stitching.cluster_stitching import stitch_clusters

    cpu = torch.device("cpu")
    floors = [(seed, f"{seed:04d}", building) for seed, building, _, _ in stage_a_floors()[:STAGE_D_FLOORS]]
    work = root / "stitching"
    cases = []  # (floor, layouts root, serialized poses, cluster files)
    for seed, bid, building in floors:
        ser = root / "out" / f"frozen_card_{bid}_cuda_serialized" / f"{bid}__floor_01.json"
        seeded_stitching.write_layout_predictions(work / "layouts", bid, building, seed)
        clusters = seeded_stitching.write_cluster_inputs(work / f"clusters_{bid}", bid, building, str(ser), seed)
        cases.append((bid, str(work / "layouts"), ser, clusters))
    # Floor 0 again on phase 6's seeded MHNet files (sinusoid boundaries,
    # nonzero uncertainties).
    cases.append(("0000", str(root / "mhnet"), cases[0][2], None))

    def layouts(bid, pred_root, ser, d, tag):
        return stitch_building_layouts(bid, pred_root, str(root / "zind"), str(ser), str(work / f"out_{tag}_{d.type}"),
                                       device=d)

    def scores(bid, files, d):
        out_dir = work / f"scores_{bid}_{d.type}"
        got = stitch_clusters(files["clusters"], files["pred_dir"], files["floor_map"], str(out_dir), device=d)
        return got, json.loads((out_dir / "score.json").read_text())

    layouts(*cases[0][:3], dev, "warmup")
    torch.cuda.synchronize()
    device_mod.reset_launch_counts()
    out = {"floors": []}
    for k, (bid, pred_root, ser, files) in enumerate(cases):
        tag = "mhnet" if files is None else "layouts"
        row = {"floor": bid, "layouts": tag}
        results = {}
        for side, d in (("card", dev), ("cpu", cpu)):
            graph = load_estimated_pose_graph(ser, EstimatedBoundaryType.HNET_CORNERS, str(root / "zind"), pred_root)
            t0 = time.perf_counter()
            shapes, rings = layouts(bid, pred_root, ser, d, f"{tag}{k}")
            if d.type == "cuda":
                torch.cuda.synchronize()
            row[f"layouts_ms_{side}"] = (time.perf_counter() - t0) * 1e3
            results[side] = {"groups": group_panos_by_room(graph, device=d), "fused": fused_key(shapes),
                             "rings": rings}
            if files is not None:
                t0 = time.perf_counter()
                results[side]["scores"] = scores(bid, files, d)
                if d.type == "cuda":
                    torch.cuda.synchronize()
                row[f"clusters_ms_{side}"] = (time.perf_counter() - t0) * 1e3
        card, host = results["card"], results["cpu"]
        if card["groups"] != host["groups"]:
            raise AssertionError(f"stitching floor {bid} ({tag}): room groups {card['groups']} on the card, "
                                 f"{host['groups']} on the CPU")
        if card["fused"] != host["fused"] or not all(
                np.array_equal(a, b) for g, h in zip(card["rings"], host["rings"]) for a, b in zip(g, h)):
            raise AssertionError(f"stitching floor {bid} ({tag}): a fused ring differs between the card and the CPU")
        if files is not None and card["scores"] != host["scores"]:
            raise AssertionError(f"stitching floor {bid}: score.json {card['scores'][1]} on the card, "
                                 f"{host['scores'][1]} on the CPU")
        row["groups"] = [len(g) for g in card["groups"]]
        row["fused_rings"] = sum(len(g) for g in card["rings"])
        if files is not None:
            row["iou"] = [float(s["iou"]) for s in card["scores"][0]]
        out["floors"].append(row)
        log(f"phase 7: stitching floor {bid} ({tag}): groups {row['groups']}, {row['fused_rings']} fused rings"
            + (f", cluster IoU {row['iou']}" if files is not None else "")
            + f"; card = CPU (groups in order, rings bit for bit{', score.json' if files is not None else ''}); "
            f"stitch_building_layouts {row['layouts_ms_card']:.1f} ms card, {row['layouts_ms_cpu']:.1f} ms CPU"
            + (f"; stitch_clusters {row['clusters_ms_card']:.1f} ms card, {row['clusters_ms_cpu']:.1f} ms CPU"
               if files is not None else ""))
    out["launches"] = device_mod.launch_counts()
    log(f"phase 7: stitching launches of B1-B3 (none on this path): {out['launches']}")
    if any(out["launches"].values()):
        raise AssertionError(f"stitching launched a kernel of the scoring path: {out['launches']}")

    # The raster on the card: what it saw and its summed kernel time.
    bid, pred_root, ser, files = cases[0]
    for name, fn in (("layouts", lambda: layouts(bid, pred_root, ser, dev, "profile")),
                     ("clusters", lambda: scores(bid, files, dev))):
        calls = raster_calls_of(fn)
        kernels_n, kernel_ms = profiled_kernels(fn)
        row = {"raster_calls": len(calls), "cells": sum(nx * ny for _, nx, ny in calls),
               "cell_edge_tests": sum(m * nx * ny for m, nx, ny in calls),
               "largest_grid": max((ny, nx) for _, nx, ny in calls), "edges": sorted({m for m, _, _ in calls}),
               "kernels": kernels_n, "kernel_ms": kernel_ms}
        out[f"raster_{name}"] = row
        log(f"phase 7: floor {bid}, {name} flow on the card: {row['raster_calls']} raster calls, {row['cells']} cells, "
            f"{row['cell_edge_tests']} cell x edge tests, largest grid {row['largest_grid'][0]}x{row['largest_grid'][1]}, "
            f"edge counts {row['edges']}; torch.profiler: {kernels_n} kernels, {kernel_ms} ms of kernel time in the call")
    layout_rows = [r for r in out["floors"] if r["layouts"] == "layouts"]
    for key in ("layouts_ms_card", "layouts_ms_cpu", "clusters_ms_card", "clusters_ms_cpu"):
        out[f"{key}_median"] = statistics.median(r[key] for r in layout_rows)
    log(f"phase 7: stitching per floor (median of {len(layout_rows)}): stitch_building_layouts "
        f"{out['layouts_ms_card_median']:.1f} ms card, {out['layouts_ms_cpu_median']:.1f} ms CPU; stitch_clusters "
        f"{out['clusters_ms_card_median']:.1f} ms card, {out['clusters_ms_cpu_median']:.1f} ms CPU")
    return out


def write_corpus_inputs(root: Path, bid: str, seed: int) -> dict:
    """Floor `bid` of phase 6 as a ZInD raw directory: its panos as
    1024x2048 JPEGs from the port's encoder (synthetic_bank at full size),
    its depths as 512x1024 u16 PNGs. Returns pano ID -> pano path."""
    import numpy as np

    from salve_tpu_torch.dataset.seeded_predictions import pano_image_paths
    from salve_tpu_torch.dataset.synthetic_bank import make_synthetic_pano_bank
    from salve_tpu_torch.native import jpeg, png

    building = json.loads((root / "zind" / bid / "zind_data.json").read_text())
    paths = pano_image_paths(building)
    ids = sorted(paths)
    depths, rgbs = make_synthetic_pano_bank(len(ids), h=1024, w=2048, seed=seed)
    out = {}
    for j, pid in enumerate(ids):
        f = root / "zind" / bid / paths[pid]
        f.parent.mkdir(parents=True, exist_ok=True)
        jpeg.write_jpeg(f, np.round(rgbs[j] * 255.0).astype(np.uint8))
        d = root / "depth" / bid / f"{f.stem}.depth.png"
        d.parent.mkdir(parents=True, exist_ok=True)
        d.write_bytes(png.encode_png(np.ascontiguousarray(depths[j, ::2, ::2])))
        out[pid] = str(f)
    return out


def file_tree(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def subset_hypotheses(src: Path, dst: Path, bid: str, n: int) -> list:
    """The first `n` hypotheses of floor `bid` (gt_alignment_approx, then
    incorrect_alignment), copied under `dst`: a prefix of each label type,
    so each keeps its pair index and its file names. Returns (label, index,
    path) of each."""
    import shutil

    kept = []
    for label in ("gt_alignment_approx", "incorrect_alignment"):
        files = sorted((src / bid / "floor_01" / label).glob("*.json"))[: max(n - len(kept), 0)]
        (dst / bid / "floor_01" / label).mkdir(parents=True, exist_ok=True)
        for k, f in enumerate(files):
            shutil.copy(f, dst / bid / "floor_01" / label / f.name)
            kept.append((label, k, f))
    return kept


def corpus_phase(dev, root: Path) -> dict:
    """Phase 8: the file-contract corpus renderer on phase 6's floors
    (module docstring)."""
    import numpy as np
    import torch

    from salve_tpu_torch import device as device_mod
    from salve_tpu_torch.geometry.sim2 import Sim2
    from salve_tpu_torch.ops import warp
    from salve_tpu_torch.rendering import bev_pair
    from salve_tpu_torch.rendering import dataset_renderer as dr
    from salve_tpu_torch.utils import profiler

    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    panos = {bid: write_corpus_inputs(root, bid, seed) for seed, bid in enumerate(CORPUS_FLOORS)}
    out = {"inputs_s": time.perf_counter() - t0, "floors": {}}
    log(f"phase 8: wrote {sum(len(p) for p in panos.values())} 1024x2048 JPEG panos and 512x1024 u16 depth PNGs "
        f"for floors {list(CORPUS_FLOORS)} in {out['inputs_s']:.1f} s")
    common = dict(depth_save_root=str(root / "depth"), raw_dataset_dir=str(root / "zind"), split=None)

    def render(tag, d, hyp_root, bids, use_warp=None, batch=dr.DEFAULT_BATCH_SIZE, layout=False):
        """One arm over `bids`: the tree, per-floor rows, launches and stage timers."""
        dst = root / "corpus" / tag
        rows = []
        device_mod.reset_launch_counts()
        profiler.reset_stage_timers()
        for bid in bids:
            if d.type == "cuda":
                torch.cuda.synchronize()
            t = time.perf_counter()
            n = dr.render_pairs(
                bev_save_root=str(dst if not layout else root / "corpus" / "unused"),
                layout_save_root=str(dst) if layout else None,
                render_modalities=["layout"] if layout else ["rgb_texture"],
                hypotheses_save_root=str(hyp_root), building_id=bid, batch_size=batch, use_warp=use_warp,
                mhnet_predictions_data_root=str(root / "mhnet") if layout else None, device=d, **common)
            if d.type == "cuda":
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            pairs = n if layout else n // 2  # texture: one item per pair and surface
            rows.append({"floor": bid, "items": n, "pairs": pairs, "ms": ms, "pairs_per_s": pairs / (ms / 1e3)})
        launches = device_mod.launch_counts()
        stages = {k: v for k, v in profiler.stage_summary().items() if k.startswith("render/")}
        return dst, rows, launches, stages

    def same_trees(what, a, b):
        ta, tb = file_tree(a), file_tree(b)
        if not ta or ta != tb:
            raise AssertionError(f"phase 8: {what}: {len(ta)} files on the card, {len(tb)} on the CPU, "
                                 f"{sum(ta.get(k) != v for k, v in tb.items())} differ")
        return len(ta)

    def show(tag, rows, launches, stages):
        for r in rows:
            log(f"phase 8: {tag}, floor {r['floor']}: {r['pairs']} pairs ({r['items']} pair-surface items) in "
                f"{r['ms']:.1f} ms, {r['pairs_per_s']:.2f} pairs/s")
        log(f"phase 8: {tag}: launches {launches}; stage timers " + ", ".join(
            f"{k.split('/')[1]} {v['total_s'] * 1e3:.1f} ms ({v['count']})" for k, v in sorted(stages.items())))

    # Warp arm, every pair of both floors, on the card and on the CPU.
    warp_card, rows, launches, stages = render("warp_card", dev, root / "hyp", CORPUS_FLOORS, use_warp=True,
                                               batch=dr.WARP_BATCH_SIZE)
    show("warp arm, card", rows, launches, stages)
    expect = {"splat": 4 * len(CORPUS_FLOORS), "fill": 4 * len(CORPUS_FLOORS), "warp": 0, "layout": 0}
    if launches != expect:
        raise AssertionError(f"phase 8: warp arm launches {launches}, expected {expect} (an identity and an "
                             f"extended bank a surface and floor)")
    out["warp_card"] = {"rows": rows, "launches": launches, "stages": stages}
    warp_cpu, rows, launches_cpu, stages = render("warp_cpu", cpu, root / "hyp", CORPUS_FLOORS, use_warp=True,
                                                  batch=dr.WARP_BATCH_SIZE)
    show("warp arm, CPU", rows, launches_cpu, stages)
    out["warp_cpu"] = {"rows": rows, "stages": stages}
    out["warp_files"] = same_trees("warp arm", warp_card, warp_cpu)
    log(f"phase 8: warp arm, floors {list(CORPUS_FLOORS)}: card tree equals the CPU's, {out['warp_files']} files "
        f"(sha256 of each)")

    # A second call renders nothing: every pair's two files exist.
    device_mod.reset_launch_counts()
    again = sum(dr.render_pairs(bev_save_root=str(warp_card), layout_save_root=None, render_modalities=["rgb_texture"],
                                hypotheses_save_root=str(root / "hyp"), building_id=bid, use_warp=True, device=dev,
                                **common) for bid in CORPUS_FLOORS)
    again_launches = device_mod.launch_counts()
    if again != 0 or any(again_launches.values()):
        raise AssertionError(f"phase 8: a second call rendered {again} items, launches {again_launches}")
    log(f"phase 8: a second call renders {again} pairs, launches {again_launches}")

    # Direct arm, 64 pairs of floor 0, on the card and the CPU; img2 equals the warp arm's.
    bid0 = CORPUS_FLOORS[0]
    kept = subset_hypotheses(root / "hyp", root / "hyp_direct", bid0, CORPUS_DIRECT_PAIRS)
    direct_card, rows, launches, stages = render("direct_card", dev, root / "hyp_direct", [bid0], use_warp=False)
    show("direct arm, card", rows, launches, stages)
    n_batches = -(-len(kept) // dr.DEFAULT_BATCH_SIZE)  # a surface's work spans both label types
    expect = {"splat": 2 * n_batches, "fill": 2 * n_batches, "warp": 0, "layout": 0}
    if launches != expect:
        raise AssertionError(f"phase 8: direct arm launches {launches}, expected {expect} (one B1 and one B2 a "
                             f"batch of {dr.DEFAULT_BATCH_SIZE} pairs and surface)")
    out["direct_card"] = {"rows": rows, "launches": launches, "stages": stages}
    direct_cpu, rows, _, stages = render("direct_cpu", cpu, root / "hyp_direct", [bid0], use_warp=False)
    show("direct arm, CPU", rows, {}, stages)
    out["direct_cpu"] = {"rows": rows, "stages": stages}
    out["direct_files"] = same_trees("direct arm", direct_card, direct_cpu)
    same_img2 = 0
    for label, k, f in kept:
        i2, uuid = int(f.stem.split("_")[1]), f.stem.split("__")[-1]
        for surface in ("floor", "ceiling"):
            name = bev_pair.bev_fname_from_img_fpath(k, uuid, surface, panos[bid0][i2])
            a = (direct_card / label / bid0 / name).read_bytes()
            if a != (warp_card / label / bid0 / name).read_bytes():
                raise AssertionError(f"phase 8: img2 {label}/{name} differs between the direct and the warp arm")
            same_img2 += 1
    log(f"phase 8: direct arm, {len(kept)} pairs of floor {bid0}: card tree equals the CPU's "
        f"({out['direct_files']} files); each of its {same_img2} img2 files equals the warp arm's")

    # Layout modality on floor 0's seeded MHNet files (phase 6), card against CPU.
    subset_hypotheses(root / "hyp", root / "hyp_layout", bid0, CORPUS_LAYOUT_PAIRS)
    lay_card, rows, launches, stages = render("layout_card", dev, root / "hyp_layout", [bid0], layout=True)
    show("layout, card", rows, launches, stages)
    if launches["layout"] == 0 or any(n for k, n in launches.items() if k != "layout"):
        raise AssertionError(f"phase 8: the layout modality launched {launches}, not the layout kernel alone")
    lay_cpu, rows_cpu, _, _ = render("layout_cpu", cpu, root / "hyp_layout", [bid0], layout=True)
    show("layout, CPU", rows_cpu, {}, {})
    out["layout"] = {"card": rows, "cpu": rows_cpu, "files": same_trees("layout", lay_card, lay_cpu)}
    log(f"phase 8: layout, {CORPUS_LAYOUT_PAIRS} pairs of floor {bid0}: card tree equals the CPU's "
        f"({out['layout']['files']} files)")

    # One batch of 64: the host warp (as the renderer runs it, and single-threaded)
    # against the port's torch gather on the card, fetch included.
    ids = sorted(panos[bid0])
    depths = torch.as_tensor(np.stack([bev_pair.load_depth_mm(str(root / "depth" / bid0 / f"{Path(panos[bid0][i]).stem}.depth.png"))
                                       for i in ids]).astype(np.float32), device=dev)
    rgbs = torch.as_tensor(np.stack([bev_pair.load_pano_rgb(panos[bid0][i]) for i in ids]).astype(np.float32), device=dev)
    render_cfg = bev_pair.BEVRenderConfig()
    _, bank = bev_pair.render_identity_banks(depths, rgbs, bev_pair._z_range_for_surface("floor"), render_cfg,
                                             2 * render_cfg.img_px)
    bank_np = bank.cpu().numpy()
    files = sorted((root / "hyp" / bid0 / "floor_01" / "incorrect_alignment").glob("*.json"))[: dr.WARP_BATCH_SIZE]
    sims = [Sim2.from_json(f) for f in files]
    R = np.stack([s.rotation for s in sims]).astype(np.float32)
    t = np.stack([s.translation for s in sims]).astype(np.float32) * bev_pair.HOHO_S_ZIND_SCALE_FACTOR
    idx = np.array([ids.index(int(f.stem.split("_")[0])) for f in files])
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=8) as pool:
        host8 = dr._host_warp(pool, 8, bank_np, R, t, idx)
        w = {"host_threads8_ms": host_clock_ms(lambda: dr._host_warp(pool, 8, bank_np, R, t, idx))}
    w["host_one_thread_ms"] = host_clock_ms(lambda: warp.warp_bank_sim2_nn_host(bank_np, R, t, bank_idx=idx))
    R_d, t_d, idx_d = (torch.as_tensor(a, device=dev) for a in (R, t, idx))
    w["card_gather_fetch_ms"] = host_clock_ms(lambda: warp.warp_bank_sim2_nn(bank, R_d, t_d, bank_idx=idx_d).cpu())
    card = warp.warp_bank_sim2_nn(bank, R_d, t_d, bank_idx=idx_d).cpu().numpy()
    w["mismatch_share"] = float(np.mean(card != host8))
    out["warp_compare"] = w
    log(f"phase 8: one batch of {len(files)} floor warps from 1001^2 banks to 501^2, host ms (median of 3): "
        f"warp_bank_sim2_nn_host on 8 threads {w['host_threads8_ms']:.2f}, on one {w['host_one_thread_ms']:.2f}; "
        f"torch warp_bank_sim2_nn on the card with the fetch {w['card_gather_fetch_ms']:.2f}; share of values "
        f"that differ {w['mismatch_share']:.3e} (the reference's own bound between its two warps: 5e-5)")
    if w["mismatch_share"] > 5e-5:
        raise AssertionError("phase 8: the card's gather warp and the host warp differ beyond the reference's bound")
    return out


def count_model_flops(model, images) -> float:
    """Multiply-adds x 2 of one forward of `model` on `images`, from the
    output shape of every conv and linear layer (forward hooks)."""
    import torch

    macs = []

    def conv_hook(m, inp, out):
        macs.append(out.numel() * (m.in_channels // m.groups) * m.kernel_size[0] * m.kernel_size[1])

    def linear_hook(m, inp, out):
        macs.append(out.numel() * m.in_features)

    hooks = [m.register_forward_hook(conv_hook if isinstance(m, torch.nn.Conv2d) else linear_hook)
             for m in model.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        with torch.no_grad():
            model.eval()(images)
    finally:
        for h in hooks:
            h.remove()
    return 2.0 * float(sum(macs))


def grad_rel_max(card: dict, cpu: dict) -> float:
    """Largest |card - cpu| of each gradient over its CPU tensor's largest
    magnitude. A tensor zero on both sides agrees; a card gradient that is
    not finite, or that is zero on one side only, gives infinity."""
    import math

    worst = 0.0
    for name, g in cpu.items():
        c = card[name]
        scale = float(g.abs().max())
        if not bool(c.isfinite().all()) or (scale == 0) != (not bool(c.any())):
            return math.inf
        if scale > 0:
            worst = max(worst, float((c - g).abs().max()) / scale)
    return worst


def small_step_check(dev, corpus: Path) -> dict:
    """Two train steps and one eval step at small width, the card against
    the CPU, from the same weights and augmentation draws (phase 9).

    Step 1 runs in float32. Its gradients miss most of the trunk: the last
    batch norm scale of each residual branch is Flax's 0, so the gradients
    of the branch's other convs and batch norms are exactly 0 on both
    sides. Step 2 reaches every tensor (those scales are then about +-lr).
    Both sides take it from the CPU's state after step 1, in float64: the
    first Adam step is lr * sign(g) wherever |g| is under the rounding, so
    separate first steps leave parameters up to 2 lr apart, and in float32
    the branch gradients' cancellation on the corpus's images puts cuDNN's
    and the CPU's sums up to 5e-4 of a tensor's largest magnitude apart
    (PERF.md); in float64 both are far below the bound, so what it holds is
    the card's code path. The eval step follows step 2, in float64."""
    import numpy as np
    import torch

    from salve_tpu_torch import device as device_mod
    from salve_tpu_torch.dataset.bev_pairs import BEVPairDataset
    from salve_tpu_torch.training import train as train_lib
    from salve_tpu_torch.training import transforms
    from salve_tpu_torch.training.config import TrainingConfig

    cfg = TrainingConfig(num_layers=18, resize_h=72, resize_w=72, train_h=64, train_w=64, batch_size=8,
                         compute_dtype="float32", data_root=str(corpus), split_overrides=dict(TRAIN_SPLITS))
    ds = BEVPairDataset("train", cfg, workers=8)
    idx = list(range(4)) + list(range(len(ds) - 4, len(ds)))  # 4 aligned, 4 misaligned
    imgs, labels, _ = ds.load_batch(idx)
    augs = [transforms.draw_augment_params(torch.Generator().manual_seed(3 + s), 8, imgs.shape[1], 72, 72, 64, 64)
            for s in range(2)]
    step = train_lib.make_train_step(cfg)
    devices = {"cuda": dev, "cpu": torch.device("cpu")}
    states = {k: train_lib.create_train_state(cfg, torch.Generator().manual_seed(0), 10, d)
              for k, d in devices.items()}
    out = {k: {"steps": []} for k in states}

    def take(k, state, aug):
        state, m = step(state, imgs, labels, aug)
        out[k]["steps"].append({"loss": float(m["loss"]),
                                "grads": {n: p.grad.detach().cpu() for n, p in state.model.named_parameters()}})
        return state

    for k in states:
        states[k] = take(k, states[k], augs[0])
    names = states["cpu"].param_names()
    after1 = (states["cpu"].model.state_dict(), states["cpu"].optimizer.state_dict(names))
    for k, d in devices.items():
        model = train_lib.build_model(cfg).double().to(d)
        model.load_state_dict(after1[0])
        state = train_lib.TrainState(model=model, optimizer=train_lib.make_optimizer(cfg, 10, model))
        state.optimizer.load_state_dict(after1[1], names)
        state = take(k, state, augs[1])
        ev = train_lib.make_eval_step(cfg)(state, imgs, labels)
        out[k]["stats"] = {n: v.detach().cpu() for n, v in state.model.state_dict().items() if "running" in n}
        out[k]["probs"] = ev["probs"][:, 1].cpu().numpy()
    card, cpu = out["cuda"], out["cpu"]
    loss_diff = [abs(c["loss"] - g["loss"]) for c, g in zip(card["steps"], cpu["steps"])]
    grad_rel = [grad_rel_max(c["grads"], g["grads"]) for c, g in zip(card["steps"], cpu["steps"])]
    zero = [sum(not bool(g.any()) for g in s["grads"].values()) for s in cpu["steps"]]
    stats_diff = max(float((card["stats"][k] - v).abs().max()) for k, v in cpu["stats"].items())
    prob_diff = float(np.abs(card["probs"] - cpu["probs"]).max())
    clear = np.abs(cpu["probs"] - 0.5) >= 1e-3
    labels_equal = bool(np.array_equal(card["probs"][clear] > 0.5, cpu["probs"][clear] > 0.5))
    launches = device_mod.launch_counts()
    row = {"loss_card": [s["loss"] for s in card["steps"]], "loss_cpu": [s["loss"] for s in cpu["steps"]],
           "loss_diff": loss_diff, "grad_rel_max": grad_rel, "zero_grad_tensors": zero,
           "n_grad_tensors": len(cpu["steps"][0]["grads"]), "running_stats_diff": stats_diff,
           "eval_prob_diff": prob_diff, "labels_equal": labels_equal}
    log(f"phase 9: small width (ResNet-18, 72->64, batch 8), card vs CPU: step 1 (float32) loss "
        f"{row['loss_card'][0]:.6f} / {row['loss_cpu'][0]:.6f} (|diff| {loss_diff[0]:.2e}), largest gradient diff "
        f"{grad_rel[0]:.2e} of its tensor's max ({zero[0]} of {row['n_grad_tensors']} tensors 0 on both sides); "
        f"step 2 (float64, from the CPU's state) loss |diff| {loss_diff[1]:.2e}, gradients {grad_rel[1]:.2e} "
        f"({zero[1]} zero); running stats {stats_diff:.2e}, eval probs {prob_diff:.2e}, labels equal {labels_equal}")
    if (loss_diff[0] > 1e-4 or grad_rel[0] > 1e-3 or loss_diff[1] > 1e-9 or grad_rel[1] > 1e-9 or zero[1]
            or stats_diff > 1e-9 or prob_diff > 1e-9 or not labels_equal):
        raise AssertionError(f"phase 9: the card's train steps disagree with the CPU's: {row}")
    if any(launches.values()):
        raise AssertionError(f"phase 9: the small-width step launched {launches}")
    return row


def training_phase(dev, corpus: Path, root: Path) -> dict:
    """Phase 9: the verifier trained on phase 8's warp-arm corpus (module
    docstring). `corpus` is a rendered-BEV tree with buildings 0000 and 0001."""
    import dataclasses

    import numpy as np
    import torch

    from salve_tpu_torch import device as device_mod
    from salve_tpu_torch.dataset.bev_pairs import BEVPairDataset
    from salve_tpu_torch.training import device_corpus, loop
    from salve_tpu_torch.training import train as train_lib
    from salve_tpu_torch.training import transforms
    from salve_tpu_torch.training.config import load_training_config

    t_phase = time.perf_counter()
    device_mod.reset_launch_counts()
    out = {"small": small_step_check(dev, corpus)}

    repo = Path(__file__).resolve().parent
    base = dataclasses.replace(load_training_config(str(repo / TRAIN_CONFIG)), data_root=str(corpus),
                               num_epochs=TRAIN_EPOCHS, split_overrides=dict(TRAIN_SPLITS))
    val_ds = BEVPairDataset("val", base, workers=base.workers)
    probe = torch.as_tensor(val_ds.load_batch(range(FIXED_BATCH))[0], device=dev)

    # The train split's tuple order over phase 8's card and CPU trees (equal
    # files): the sorted one, whatever the directory listing's order (salve_tpu
    # takes the listing's), so one corpus trains alike on every machine. The
    # digests let two calls be compared.
    orders = {}
    for tree in (corpus, corpus.parent / "warp_cpu"):
        ds = BEVPairDataset("train", dataclasses.replace(base, data_root=str(tree)), workers=1)
        orders[tree.name] = [tuple(Path(f).relative_to(tree).as_posix() for f in t[:-1]) for t in ds.data_list]
    order = orders[corpus.name]
    files = hashlib.sha256()
    for f in sorted(p for p in corpus.rglob("*.jpg")):
        files.update(f.relative_to(corpus).as_posix().encode() + hashlib.sha256(f.read_bytes()).digest())
    out["tuple_order"] = {"tuples": len(order), "same_on_both_trees": order == orders["warp_cpu"],
                          "sorted": order == sorted(order),
                          "order_sha256": hashlib.sha256(repr(order).encode()).hexdigest(),
                          "files_sha256": files.hexdigest()}
    log(f"phase 9: the train split's {len(order)} tuples in listing order: the card's and the CPU's trees (equal "
        f"files) give the same order: {out['tuple_order']['same_on_both_trees']}; sorted: "
        f"{out['tuple_order']['sorted']}; sha256 of the order {out['tuple_order']['order_sha256'][:16]}, of the "
        f"card tree's files {out['tuple_order']['files_sha256'][:16]}")
    if order != orders["warp_cpu"] or order != sorted(order):
        raise AssertionError("phase 9: the train split's tuple order is not the sorted one on both trees")

    def eval_logits(model):
        with torch.no_grad():
            x = transforms.preprocess_eval(probe, base.train_h, base.train_w)
            return model.eval()(train_lib.split_images(x)).float()

    # Each best checkpoint: the saved model's eval logits on a fixed val batch.
    saved = {}
    save_checkpoint = train_lib.save_checkpoint

    def save_and_probe(save_dir, state, epoch, val_mAcc, cfg):
        path = save_checkpoint(save_dir, state, epoch, val_mAcc, cfg)
        saved[path] = eval_logits(state.model)
        return path

    gathers = []
    gather = device_corpus.DeviceCorpus.gather

    def counted_gather(self, rows):
        gathers.append(len(rows))
        return gather(self, rows)

    runs = {}
    train_lib.save_checkpoint = save_and_probe
    device_corpus.DeviceCorpus.gather = counted_gather
    try:
        for name, budget in (("streamed", 0.0), ("device_corpus", 1.0)):
            cfg = dataclasses.replace(base, model_save_dirpath=str(root / name), device_corpus_gb=budget)
            gathers.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = loop.train(cfg, seed=0, device=dev)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            losses = res["train_avg_loss"] + res["val_avg_loss"]
            runs[name] = {"seconds": secs, "results": res, "gathers": list(gathers)}
            log(f"phase 9: train() {name}, {TRAIN_EPOCHS} epochs in {secs:.1f} s: train loss "
                f"{[round(v, 6) for v in res['train_avg_loss']]}, val loss {[round(v, 6) for v in res['val_avg_loss']]}, "
                f"val mAcc {[round(v, 4) for v in res['val_mAcc']]}, device-corpus gathers {gathers}")
            if not np.all(np.isfinite(losses)) or len(res["val_mAcc"]) != TRAIN_EPOCHS:
                raise AssertionError(f"phase 9: train() {name}: results {res}")
            if (name == "streamed") == bool(gathers):
                raise AssertionError(f"phase 9: train() {name} took the wrong data path: gathers {gathers}")
    finally:
        train_lib.save_checkpoint = save_checkpoint
        device_corpus.DeviceCorpus.gather = gather
    out["runs"] = runs

    # The last best checkpoint of the streamed run reloads bit for bit.
    ckpts = sorted(root.glob("streamed/*/train_ckpt.pt"))
    if len(ckpts) != 1 or str(ckpts[0]) not in saved:
        raise AssertionError(f"phase 9: checkpoints {ckpts}, saved {list(saved)}")
    state = train_lib.create_train_state(base, torch.Generator().manual_seed(9), 1, dev)
    state = train_lib.load_model_checkpoint(str(ckpts[0]), state)
    if not torch.equal(eval_logits(state.model), saved[str(ckpts[0])]):
        raise AssertionError("phase 9: the reloaded checkpoint's eval logits differ from the saved model's")
    log(f"phase 9: checkpoint {ckpts[0].name} ({ckpts[0].stat().st_size / 1e6:.1f} MB, step {state.step}) "
        f"reloads to the saved model's eval logits bit for bit ({FIXED_BATCH} val tuples)")
    del state

    # evaluate() on the val split: batch files covering the split in order.
    preds = root / "preds"
    prec, rec, macc = loop.evaluate(base, str(ckpts[0]), "val", str(preds), device=dev)
    files = sorted(preds.glob("batch_*.json"), key=lambda f: int(f.stem.split("_")[1]))
    got = [json.loads(f.read_text()) for f in files]
    want = val_ds.data_list
    covered = ([t for g in got for t in zip(g["fp0"], g["fp1"], g["y_true"])]
               == [(t[0], t[1], t[-1]) for t in want])
    out["evaluate"] = {"files": len(files), "precision": prec, "recall": rec, "mAcc": macc}
    log(f"phase 9: evaluate on val: {len(files)} batch files, {sum(len(g['y_hat']) for g in got)} predictions "
        f"covering the {len(want)} val tuples in dataset order: {covered}; precision={prec:.4f} recall={rec:.4f} "
        f"mAcc={macc:.4f}")
    if len(files) != 2 or not covered:
        raise AssertionError("phase 9: evaluate's batch files do not cover the val split in order")

    # Ten steps on one fixed batch of 32 at full width, fresh crops and flips
    # each step, the poly LR over 50 steps, as
    # tests/training/test_train_step.py:39 runs the JAX step on its
    # class-separable batch (label 1 bright, label 0 dark): the loss must fall
    # and the last step's accuracy reach 0.8. The same steps on a batch of the
    # corpus (16 aligned pairs, 16 not) are logged and must stay finite: its
    # labels differ only in geometry, which ten steps from random weights do
    # not learn reliably.
    train_ds = BEVPairDataset("train", base, workers=base.workers)
    half = FIXED_BATCH // 2
    step = train_lib.make_train_step(base)

    def ten_steps(imgs, labels):
        state = train_lib.create_train_state(dataclasses.replace(base, batch_size=FIXED_BATCH),
                                             torch.Generator().manual_seed(1), FIXED_BATCH_MAX_ITER, dev)
        gen = torch.Generator().manual_seed(2)
        losses = []
        for _ in range(FIXED_BATCH_STEPS):
            state, m = step(state, imgs, labels, gen)
            losses.append(float(m["loss"]))
        return losses, float(m["accuracy"])

    imgs, labels, _ = train_ds.load_batch(list(range(half)) + list(range(len(train_ds) - half, len(train_ds))))
    corpus_losses, _ = ten_steps(torch.as_tensor(imgs, device=dev), labels)
    labels = np.repeat(np.array([1, 0], np.int32), half)
    sep = np.random.default_rng(0).uniform(0, 40, imgs.shape) + 180.0 * labels[:, None, None, None, None]
    fixed, accuracy = ten_steps(torch.as_tensor(sep.astype(np.uint8), device=dev), labels)
    out["fixed_batch"] = {"losses": fixed, "accuracy": accuracy, "corpus_losses": corpus_losses}
    log(f"phase 9: {FIXED_BATCH_STEPS} steps on one fixed batch of {FIXED_BATCH} at full width, fresh draws: "
        f"class-separable losses {[round(v, 5) for v in fixed]}, last accuracy {accuracy:.3f}; corpus batch "
        f"losses {[round(v, 5) for v in corpus_losses]}")
    if not fixed[-1] < fixed[0] or accuracy < 0.8 or not np.all(np.isfinite(fixed + corpus_losses)):
        raise AssertionError("phase 9: the loss did not fall on a fixed batch")
    del imgs, sep

    launches = device_mod.launch_counts()
    out["launches"] = launches
    log(f"phase 9: launches of B1-B3 over the phase (the training path runs none): {launches}")
    if any(launches.values()):
        raise AssertionError(f"phase 9: the training path launched {launches}")

    # Times on the card's clock at the released config's batch of 256.
    b = base.batch_size
    corpus_dev = device_corpus.DeviceCorpus(train_ds, dev)
    rows = np.random.default_rng(0).permutation(len(train_ds))[:b]
    batch_u8 = corpus_dev.gather(rows)
    labels_b = torch.as_tensor(np.array([train_ds.data_list[r][-1] for r in rows]), device=dev)
    state = train_lib.create_train_state(base, torch.Generator().manual_seed(4), 100, dev)
    step = train_lib.make_train_step(base)
    eval_step = train_lib.make_eval_step(base)

    def two_steps(s):
        g = torch.Generator().manual_seed(5)
        for _ in range(2):
            s, _ = step(s, batch_u8, labels_b, g)
        return s

    out["repeat"] = repeat_check(f"phase 9: train step at batch {b} (ResNet-{base.num_layers}, {base.train_h}^2, "
                                 f"{base.compute_dtype}), 2 steps", state, two_steps)
    gen = torch.Generator().manual_seed(5)
    torch.cuda.reset_peak_memory_stats(dev)
    # The step under the training policy, as train() runs it, and without it,
    # in turns (policy, without, without, policy).
    turns = {True: [], False: []}
    for policy in (True, False, False, True):
        with device_mod.deterministic_algorithms() if policy else contextlib.nullcontext():
            turns[policy].append(time_ms(lambda: step(state, batch_u8, labels_b, gen), rounds=5, per_round=2,
                                         warmup=2, prefill=False))
    t = {"train_step_ms": statistics.mean(turns[True]), "train_step_ms_without_policy": statistics.mean(turns[False]),
         "train_step_ms_turns": [turns[True][0], turns[False][0], turns[False][1], turns[True][1]]}
    t["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    t["train_tuples_per_s"] = b / (t["train_step_ms"] / 1e3)
    t["train_tuples_per_s_without_policy"] = b / (t["train_step_ms_without_policy"] / 1e3)
    t["eval_step_ms"] = time_ms(lambda: eval_step(state, batch_u8, labels_b), rounds=5, per_round=2, warmup=2,
                                prefill=False)
    t["eval_tuples_per_s"] = b / (t["eval_step_ms"] / 1e3)
    t["gather_ms"] = time_ms(lambda: corpus_dev.gather(rows), rounds=5, per_round=10, warmup=2)
    first = train_ds.data_list[:b]
    t["host_load_ms"] = host_clock_ms(lambda: train_ds._load_tuples(first))
    x = transforms.preprocess_eval(batch_u8, base.train_h, base.train_w)
    flops = 3.0 * count_model_flops(state.model, train_lib.split_images(x))
    t["step_model_flops"] = flops
    t["bf16_peak_share"] = flops / (t["train_step_ms"] / 1e3) / BF16_FLOPS_PER_S
    out["times"] = t
    card = card_line()
    log(f"phase 9: {card}: train step at batch {b} (ResNet-{base.num_layers}, {base.train_h}^2, "
        f"{base.compute_dtype}) under the deterministic policy {t['train_step_ms']:.2f} ms device "
        f"(CUDA events, median of 5 rounds of 2 after 2 warm-up steps, mean of 2 turns), "
        f"{t['train_tuples_per_s']:.1f} tuples/s; without the policy {t['train_step_ms_without_policy']:.2f} ms, "
        f"{t['train_tuples_per_s_without_policy']:.1f} tuples/s (turns policy/without/without/policy "
        f"{[round(x, 3) for x in t['train_step_ms_turns']]} ms); peak device memory {t['peak_memory_gb']:.2f} GB")
    log(f"phase 9: {card}: eval step at batch {b} {t['eval_step_ms']:.2f} ms, {t['eval_tuples_per_s']:.1f} tuples/s; "
        f"device-corpus gather of {b} tuples {t['gather_ms']:.4f} ms; host load of one streamed batch "
        f"({train_ds.n_imgs * b} decodes and resizes, {base.workers} threads) {t['host_load_ms']:.1f} ms (median of 3)")
    log(f"phase 9: {card}: step model FLOPs {flops / 1e12:.3f} T (forward multiply-adds x 2, x 3 for forward + "
        f"backward), {100 * t['bf16_peak_share']:.2f}% of the {BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s dense bf16 peak")
    del state, corpus_dev, batch_u8
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 9: {out['seconds']:.1f} s")
    return out


def hohonet_flops(model, rgb) -> float:
    """Multiply-adds x 2 of one HoHoNet forward on `rgb`: every Conv2d and
    Linear module from its output shape (forward hooks), plus the products
    taken from weights directly: the packed q/k/v projection, the scores and
    the context, the height compression's and the head's 1x1 convs, and the
    inverse DCT."""
    from salve_tpu_torch.models import hohonet as th

    b = rgb.shape[0]
    w = model.input_hw[1] // th.WIDTH_DOWN
    e, k, h = th.EMB_DIM, th.N_DCT_COMPONENTS, model.input_hw[0]
    extra = b * (w * e * 3 * e + 2 * w * w * e + w * model.decode.proj.in_channels * e + w * e * k + w * k * h)
    return count_model_flops(model, rgb) + 2.0 * extra


def depth_small_step_check(dev, zind: Path) -> dict:
    """Two depth train steps at small width (ResNet-18, embed 64, 1 block,
    64x128, batch 2), the card against the CPU from one state (phase 10).
    Step 1 in float32 from Flax-style weights; step 2 in float64 from the
    CPU's state after step 1 (in float32 some early trunk gradients are sums
    with heavy cancellation, a few 1e-3 of a tensor's max apart between two
    float32 runs; tests/test_torch_depth_net.py)."""
    import numpy as np
    import torch

    from salve_tpu_torch.training import depth as depth_train

    small = dict(num_layers=18, embed_dim=64, num_blocks=1, input_hw=(64, 128), compute_dtype="float32")
    batch = next(depth_train.iter_layout_depth_batches(str(zind), ["0001"], 2, seed=0, synthetic_rgb=True,
                                                       hw=small["input_hw"]))
    step = depth_train.make_depth_train_step()
    devices = {"cuda": dev, "cpu": torch.device("cpu")}
    out = {k: [] for k in devices}

    def take(k, state):
        state, loss = step(state, *batch)
        names = [n for n, _ in state.model.named_parameters()]
        out[k].append({"loss": float(loss), "grads": {n: p.grad.detach().cpu() for n, p in
                                                      zip(names, state.model.parameters())},
                       "stats": {n: v.detach().cpu() for n, v in state.model.state_dict().items() if "running" in n}})
        return state

    states = {k: depth_train.create_depth_train_state(torch.Generator().manual_seed(0), device=d, **small)
              for k, d in devices.items()}
    for k in devices:
        states[k] = take(k, states[k])
    after1 = states["cpu"].model.state_dict()
    names = [n for n, _ in states["cpu"].model.named_parameters()]
    opt1 = states["cpu"].optimizer.state_dict(names)
    for k, d in devices.items():
        model = depth_train.PanoDepthNet(**small).double().to(d)
        model.load_state_dict(after1)
        state = depth_train.DepthTrainState(model=model, optimizer=depth_train.make_depth_optimizer(model, 1e-4))
        state.optimizer.load_state_dict(opt1, names)
        take(k, state)
    card, cpu = out["cuda"], out["cpu"]
    # The key projection's bias has a gradient of 0 in exact arithmetic (the
    # softmax over the keys ignores it): held apart, against the largest
    # gradient, as rounding noise on both sides.
    zero_by_math = [n for n in cpu[0]["grads"] if n.endswith("attn.key.bias")]

    def grads_apart(c, g):
        keep = [n for n in g if n not in zero_by_math]
        return grad_rel_max({n: c[n] for n in keep}, {n: g[n] for n in keep})

    def key_bias_noise(c, g):
        gmax = max(float(v.abs().max()) for v in g.values())
        return max(max(float(c[n].abs().max()), float(g[n].abs().max())) for n in zero_by_math) / gmax

    row = {"loss_card": [s["loss"] for s in card], "loss_cpu": [s["loss"] for s in cpu],
           "loss_rel_diff": [abs(c["loss"] - g["loss"]) / abs(g["loss"]) for c, g in zip(card, cpu)],
           "grad_rel_max": [grads_apart(c["grads"], g["grads"]) for c, g in zip(card, cpu)],
           "key_bias_noise": [key_bias_noise(c["grads"], g["grads"]) for c, g in zip(card, cpu)],
           "zero_grad_tensors": [sum(not bool(g.any()) for g in s["grads"].values()) for s in cpu],
           "n_grad_tensors": len(cpu[0]["grads"]),
           "running_stats_diff": [max(float((c["stats"][n] - v).abs().max()) for n, v in g["stats"].items())
                                  for c, g in zip(card, cpu)]}
    log(f"phase 10: small-width depth step (ResNet-18, embed 64, 1 block, 64x128, batch 2), card vs CPU: step 1 "
        f"(float32) loss {row['loss_card'][0]:.7f} / {row['loss_cpu'][0]:.7f} (relative diff "
        f"{row['loss_rel_diff'][0]:.2e}), largest gradient diff {row['grad_rel_max'][0]:.2e} of its tensor's max "
        f"({row['zero_grad_tensors'][0]} of {row['n_grad_tensors']} tensors 0 on both sides), running stats "
        f"{row['running_stats_diff'][0]:.2e}; step 2 (float64, from the CPU's state) loss {row['loss_rel_diff'][1]:.2e}, "
        f"gradients {row['grad_rel_max'][1]:.2e} ({row['zero_grad_tensors'][1]} zero), running stats "
        f"{row['running_stats_diff'][1]:.2e}; the key bias's gradient (0 in exact arithmetic) "
        f"{row['key_bias_noise'][0]:.1e} / {row['key_bias_noise'][1]:.1e} of the largest")
    if (row["loss_rel_diff"][0] > 1e-5 or row["grad_rel_max"][0] > 2e-2 or row["running_stats_diff"][0] > 1e-5
            or row["loss_rel_diff"][1] > 1e-9 or row["grad_rel_max"][1] > 1e-8 or row["running_stats_diff"][1] > 1e-9
            or max(row["key_bias_noise"]) > 1e-4):
        raise AssertionError(f"phase 10: the card's depth train steps disagree with the CPU's: {row}")
    return row


def depth_phase(dev, root: Path) -> dict:
    """Phase 10: monocular depth on phase 6's floors and phase 8's panos
    (module docstring)."""
    import numpy as np
    import torch

    from salve_tpu_torch import device as device_mod
    from salve_tpu_torch.cli import batch_hohonet_inference, train_depth
    from salve_tpu_torch.models import depth_net
    from salve_tpu_torch.models import hohonet as th
    from salve_tpu_torch.native import png
    from salve_tpu_torch.rendering import dataset_renderer as dr
    from salve_tpu_torch.rendering.bev_pair import load_pano_rgb
    from salve_tpu_torch.training import depth as depth_train

    t_phase = time.perf_counter()
    card = card_line()
    out = {}
    bid = CORPUS_FLOORS[0]
    zind = root / "zind"
    panos = sorted((zind / bid / "panos").glob("*.jpg"))

    # (a) HoHoNet at 512x1024, float32, seeded weights in the checkpoint's layout.
    ckpt = root / "hohonet" / "ep60_seeded.pth"
    ckpt.parent.mkdir(parents=True)
    torch.save({"state_dict": th.seeded_hohonet(th.INPUT_HW, seed=DEPTH_SEED).state_dict()}, ckpt)
    depth_root = root / "depth_hohonet"
    device_mod.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ready = batch_hohonet_inference.main(["--raw_dataset_dir", str(zind), "--depth_save_root", str(depth_root),
                                          "--building_id", bid, "--model_ckpt", str(ckpt), "--device", "cuda"])
    secs = time.perf_counter() - t0
    launches_a = device_mod.launch_counts()
    pngs = sorted((depth_root / bid).glob("*.depth.png"))
    if ready != (len(panos), 0) or [p.name.replace(".depth.png", "") for p in pngs] != [p.stem for p in panos]:
        raise AssertionError(f"phase 10: batch_hohonet_inference returned {ready}, wrote {len(pngs)} PNGs for "
                             f"{len(panos)} panos")
    hoho = {"panos": len(panos), "cli_s": secs, "panos_per_s": len(panos) / secs, "launches": launches_a}
    log(f"phase 10: {card}: batch_hohonet_inference (HoHoNet, 512x1024, float32, seeded .pth) over floor {bid}'s "
        f"{len(panos)} 1024x2048 JPEG panos in {secs:.2f} s, {hoho['panos_per_s']:.2f} panos/s (read, forward, "
        f"u16 PNG write); one PNG a pano; launches of B1-B3 {launches_a}")

    # Card against CPU on two panos: metres from the providers, mm from the PNGs.
    prov_cpu = th.load_hohonet_depth_provider(str(ckpt), device="cpu")
    prov_card = th.load_hohonet_depth_provider(str(ckpt), device=dev)
    worst_m, off, n, worst_mm = 0.0, 0, 0, 0
    for f, p in list(zip(panos, pngs))[:DEPTH_CHECK_PANOS]:
        rgb = load_pano_rgb(str(f))
        d_cpu, d_card = prov_cpu(rgb), prov_card(rgb)
        worst_m = max(worst_m, float(np.abs(d_card - d_cpu).max()))
        mm_cpu = np.clip(np.round(d_cpu * 1000.0), 0, 65535).astype(np.int64)
        mm_card = png.read_png(p).astype(np.int64)
        worst_mm = max(worst_mm, int(np.abs(mm_card - mm_cpu).max()))
        off += int((mm_card != mm_cpu).sum())
        n += mm_cpu.size
    hoho.update(card_vs_cpu_max_m=worst_m, card_vs_cpu_max_mm=worst_mm, card_vs_cpu_off_share=off / n,
                depth_range_m=[float(d_cpu.min()), float(d_cpu.max())])
    log(f"phase 10: HoHoNet card vs CPU on {DEPTH_CHECK_PANOS} panos: max |diff| {worst_m:.3e} m; u16 maps at most "
        f"{worst_mm} mm apart, on {100 * off / n:.4f}% of the pixels (depth {d_cpu.min():.3f}-{d_cpu.max():.3f} m)")
    if worst_m > 1e-4 or worst_mm > 1 or off / n > 1e-3:
        raise AssertionError(f"phase 10: the card's HoHoNet depth disagrees with the CPU's: {hoho}")
    del prov_cpu

    model = th.HoHoNetDepth().to(dev).eval()
    model.load_state_dict(th.load_hohonet_state_dict(str(ckpt)))
    x = torch.as_tensor(load_pano_rgb(str(panos[0])), dtype=torch.float32, device=dev)[None]
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        hoho["forward_ms"] = time_ms(lambda: model(x), rounds=5, per_round=5, warmup=2,
                                     sleep_cycles=DEPTH_SLEEP_CYCLES)
    hoho["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    hoho["forward_flops"] = hohonet_flops(model, x)
    hoho["fp32_peak_share"] = hoho["forward_flops"] / (hoho["forward_ms"] / 1e3) / FP32_OPS_PER_S
    log(f"phase 10: {card}: HoHoNet forward at batch 1 (512x1024, float32, no TF32) {hoho['forward_ms']:.3f} ms "
        f"device (CUDA events, median of 5 rounds of 5 behind a sleep kernel); {hoho['forward_flops'] / 1e9:.2f} G model FLOPs, "
        f"{100 * hoho['fp32_peak_share']:.2f}% of the {FP32_OPS_PER_S / 1e12:.0f} TFLOP/s float32 peak; peak "
        f"device memory {hoho['peak_memory_gb']:.3f} GB")
    out["hohonet"] = hoho
    del model, prov_card, x
    gc.collect()
    torch.cuda.empty_cache()

    # (b) PanoDepthNet at full width (ResNet-50, embed 512, 4 blocks, 512x1024, bf16).
    device_mod.reset_launch_counts()
    out["small"] = depth_small_step_check(dev, zind)
    train_bids = [f"{s:04d}" for s in range(STAGE_D_FLOORS - 1)]
    eval_bid = f"{STAGE_D_FLOORS - 1:04d}"
    ckpt_cli = root / "depth_net" / "depth.pt"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = train_depth.main(["--raw_dataset_dir", str(zind), "--model_save_fpath", str(ckpt_cli), "--synthetic_rgb",
                            "--batch_size", str(DEPTH_TRAIN_BATCH), "--num_epochs", "1", "--max_steps",
                            str(DEPTH_CLI_STEPS), "--train_buildings", ",".join(train_bids),
                            "--eval_buildings", eval_bid, "--device", "cuda"])
    cli_s = time.perf_counter() - t0
    if (res["train_steps"] != DEPTH_CLI_STEPS or not np.all(np.isfinite(res["losses"])) or not ckpt_cli.is_file()
            or not (root / "depth_net" / "depth.pt.eval.json").is_file()):
        raise AssertionError(f"phase 10: train_depth: {res}")
    net = {"cli_s": cli_s, "cli_losses": res["losses"], "eval": res["eval"]}
    log(f"phase 10: train_depth --synthetic_rgb (ResNet-50, embed 512, 4 blocks, 512x1024, bf16, batch "
        f"{DEPTH_TRAIN_BATCH}) on floors {train_bids}: {DEPTH_CLI_STEPS} steps, losses "
        f"{[round(v, 5) for v in res['losses']]}, in {cli_s:.1f} s with the host's raycasts and the evaluation; "
        f"evaluate_depth on floor {eval_bid} (seeded start, {DEPTH_CLI_STEPS} steps: no target): "
        + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in res["eval"].items()))

    # A fixed batch at full width: the loss falls, the step's time, the checkpoint reload.
    batch = next(depth_train.iter_layout_depth_batches(str(zind), [eval_bid], DEPTH_TRAIN_BATCH, seed=5,
                                                       synthetic_rgb=True))
    state = depth_train.create_depth_train_state(torch.Generator().manual_seed(1), device=dev)
    step = depth_train.make_depth_train_step()
    batch_dev = [torch.as_tensor(a, device=dev) for a in batch]
    losses = []
    for _ in range(DEPTH_FIXED_STEPS):
        state, loss = step(state, *batch_dev)
        losses.append(float(loss))
    net["fixed_batch_losses"] = losses
    log(f"phase 10: {DEPTH_FIXED_STEPS} steps on one fixed batch of {DEPTH_TRAIN_BATCH} at full width: losses "
        f"{[round(v, 5) for v in losses]}")
    if not losses[-1] < losses[0] or not np.all(np.isfinite(losses)):
        raise AssertionError("phase 10: the depth loss did not fall on a fixed batch")
    torch.cuda.reset_peak_memory_stats(dev)
    # The step runs under the training policy; `__wrapped__` is the same step
    # without it. In turns: policy, without, without, policy.
    turns = {step: [], step.__wrapped__: []}
    for fn in (step, step.__wrapped__, step.__wrapped__, step):
        turns[fn].append(time_ms(lambda: fn(state, *batch_dev), rounds=5, per_round=2, warmup=1, prefill=False))
    net["train_step_ms"] = statistics.mean(turns[step])
    net["train_step_ms_without_policy"] = statistics.mean(turns[step.__wrapped__])
    net["train_step_ms_turns"] = turns[step][:1] + turns[step.__wrapped__] + turns[step][1:]
    net["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    net["images_per_s"] = DEPTH_TRAIN_BATCH / (net["train_step_ms"] / 1e3)
    net["step_flops"] = 3.0 * count_model_flops(state.model, batch_dev[0])
    net["bf16_peak_share"] = net["step_flops"] / (net["train_step_ms"] / 1e3) / BF16_FLOPS_PER_S
    with torch.no_grad():
        net["forward_ms"] = time_ms(lambda: state.model.eval()(batch_dev[0][:1]), rounds=5, per_round=5, warmup=2,
                                    sleep_cycles=DEPTH_SLEEP_CYCLES)
    log(f"phase 10: {card}: PanoDepthNet train step at batch {DEPTH_TRAIN_BATCH} (ResNet-50, 512x1024, bf16) "
        f"under the deterministic policy {net['train_step_ms']:.2f} ms device (CUDA events, median of 5 rounds of 2, "
        f"mean of 2 turns), {net['images_per_s']:.1f} images/s; without it {net['train_step_ms_without_policy']:.2f} "
        f"ms (turns policy/without/without/policy {[round(x, 2) for x in net['train_step_ms_turns']]} ms); "
        f"step model FLOPs {net['step_flops'] / 1e12:.3f} T (convs and dense layers, x 3 for forward + "
        f"backward), {100 * net['bf16_peak_share']:.2f}% of the bf16 peak; peak device memory "
        f"{net['peak_memory_gb']:.2f} GB; eval forward at batch 1 {net['forward_ms']:.2f} ms (behind a sleep kernel)")
    ckpt_fixed = depth_train.save_depth_checkpoint(str(root / "depth_net" / "fixed.pt"), state)
    want = depth_net.make_depth_provider(state.model)(batch[0][0])
    got = depth_net.load_depth_provider(ckpt_fixed, device=dev)(batch[0][0])
    if not np.array_equal(got, want):
        raise AssertionError("phase 10: the reloaded depth checkpoint's output differs from the saved model's")
    log(f"phase 10: checkpoint {Path(ckpt_fixed).name} ({Path(ckpt_fixed).stat().st_size / 1e6:.1f} MB) reloads "
        f"to the saved model's depth bit for bit")

    def two_steps(s):
        for _ in range(2):
            s, _ = step(s, *batch_dev)
        return s

    net["repeat"] = repeat_check(f"phase 10: PanoDepthNet train step at batch {DEPTH_TRAIN_BATCH} (ResNet-50, "
                                 "512x1024, bf16), 2 steps",
                                 depth_train.create_depth_train_state(torch.Generator().manual_seed(1), device=dev),
                                 two_steps)
    net["launches"] = device_mod.launch_counts()
    log(f"phase 10: launches of B1-B3 over the depth nets' training (none on this path): {net['launches']}")
    if any(net["launches"].values()) or any(launches_a.values()):
        raise AssertionError(f"phase 10: the depth nets launched {launches_a} / {net['launches']}")
    out["depth_net"] = net
    del state, batch_dev
    gc.collect()
    torch.cuda.empty_cache()

    # (c) The corpus renderer reads HoHoNet's depth: direct arm, 8 pairs of floor 0.
    kept = subset_hypotheses(root / "hyp", root / "hyp_depth", bid, DEPTH_RENDER_PAIRS)
    dst = root / "corpus" / "depth_direct"
    device_mod.reset_launch_counts()
    t0 = time.perf_counter()
    n_items = dr.render_pairs(depth_save_root=str(depth_root), bev_save_root=str(dst), raw_dataset_dir=str(zind),
                              hypotheses_save_root=str(root / "hyp_depth"), layout_save_root=None,
                              render_modalities=["rgb_texture"], building_id=bid, use_warp=False, device=dev)
    render_s = time.perf_counter() - t0
    launches_c = device_mod.launch_counts()
    n_batches = -(-len(kept) // dr.DEFAULT_BATCH_SIZE)
    files = sorted(p for p in dst.rglob("*.jpg"))
    expect = {"splat": 2 * n_batches, "fill": 2 * n_batches, "warp": 0, "layout": 0}
    out["render"] = {"pairs": len(kept), "items": n_items, "files": len(files), "seconds": render_s,
                     "launches": launches_c}
    log(f"phase 10: render_pairs (direct arm) on {len(kept)} pairs of floor {bid} from HoHoNet's depth: "
        f"{n_items} pair-surface items, {len(files)} JPEGs in {render_s:.2f} s; launches {launches_c}")
    if launches_c != expect or n_items != 2 * len(kept) or len(files) != 4 * len(kept):
        raise AssertionError(f"phase 10: the renderer on HoHoNet's depth: launches {launches_c} (expected {expect}), "
                             f"{n_items} items, {len(files)} files")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 10: {out['seconds']:.1f} s")
    return out


def e2e_phase(dev, root: Path, depth_ckpt: Path) -> dict:
    """Phase 11: the end-to-end accuracy run, the depth-provider branch of
    the materializer, semantic renders and the helpers, and the ICP
    baseline (module docstring)."""
    import dataclasses

    import numpy as np
    import torch

    from salve_tpu_torch import device as device_mod
    from salve_tpu_torch.cli import end_to_end_eval as e2e
    from salve_tpu_torch.common.posegraph2d import compute_available_floors_for_building
    from salve_tpu_torch.dataset.procedural import write_procedural_buildings
    from salve_tpu_torch.training import loop as train_loop

    t_phase = time.perf_counter()
    card = card_line()
    out = {}

    # (a) The harness at its own defaults on procedural stand-ins for the fixture buildings.
    src, run_dir = root / "e2e_src", root / "e2e"
    write_procedural_buildings(str(src), list(E2E_BUILDINGS), base_seed=E2E_BASE_SEED)
    argv = ["--src_zind_dir", str(src), "--output_dir", str(run_dir), "--procedural_val_buildings",
            str(E2E_VAL_BUILDINGS), "--num_epochs", str(E2E_EPOCHS), "--calibrate_on_val"]
    device_mod.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    summary = e2e.main(argv + ["--device", dev.type])
    secs = time.perf_counter() - t0
    launches = device_mod.launch_counts()
    raw = run_dir / "zind"
    floors = {bid: compute_available_floors_for_building(bid, str(raw))
              for bid in sorted(p.name for p in raw.iterdir())}
    n_floors = sum(len(f) for f in floors.values())
    panos = {bid: len(list((raw / bid / "panos").glob("*.jpg"))) for bid in floors}
    if sorted(summary) != E2E_SUMMARY_KEYS or sorted(summary["verifier"]) != E2E_VERIFIER_KEYS:
        raise AssertionError(f"phase 11: the summary's keys {sorted(summary)} / {sorted(summary['verifier'])} are not "
                             "salve_tpu's")
    if summary != json.loads((run_dir / "end_to_end_eval.json").read_text()):
        raise AssertionError("phase 11: end_to_end_eval.json differs from the summary the harness returned")
    rows = summary["reconstruction"]
    eval_floors = floors[E2E_BUILDINGS[1]]
    if ([(r["building_id"], r["floor_id"]) for r in rows] != [(E2E_BUILDINGS[1], f) for f in eval_floors]
            or any(sorted(r) != E2E_REPORT_KEYS for r in rows)
            or any(r["floorplan_iou"] is None or r["percent_panos_localized"] is None for r in rows)):
        raise AssertionError(f"phase 11: the held-out floors' rows are not all finite: {rows}")
    expect = {"splat": 4 * n_floors, "fill": 4 * n_floors, "warp": 0, "layout": 0}
    if launches != expect:
        raise AssertionError(f"phase 11: the harness launched {launches}, expected {expect} (Stage B's warp arm: an "
                             "identity and an extended render a surface and floor; no other stage launches B1-B3)")
    materialize_s = {bid: summary["timings_s"][f"materialize_{bid}_s"] for bid in floors}
    out["harness"] = {"seconds": secs, "launches": launches, "floors": n_floors, "panos": panos,
                      "summary": summary,
                      "materialize_s_per_pano": {bid: materialize_s[bid] / panos[bid] for bid in floors}}
    v = summary["verifier"]
    log(f"phase 11: {card}: end_to_end_eval ({' '.join(argv[4:])}; ResNet-{v['num_layers']}, resize 128 / crop 112, "
        f"batch 16, pose2_slam, GT ray-cast depth, warp corpus) over buildings {panos} (panos) in {secs:.1f} s; "
        f"launches {launches} over {n_floors} floors")
    log(f"phase 11: verifier on the held-out building: precision {v['precision']:.4f}, recall {v['recall']:.4f}, "
        f"mAcc {v['mAcc']:.4f}; train mAcc by epoch {[round(x, 4) for x in v['train_mAcc_history']]}, best val mAcc "
        f"{v['val_mAcc_best']:.4f}; frozen threshold {summary['confidence_threshold']:.4f} (calibrated "
        f"{summary['calibration']['frozen_threshold_calibrated']}, T {summary['calibration']['temperature']:.3f})")
    for r in rows:
        log("phase 11: reconstruction " + ", ".join(f"{k} {r[k]}" for k in E2E_REPORT_KEYS))
    log("phase 11: timings_s " + json.dumps(summary["timings_s"]))
    log("phase 11: materializer s a pano (host ray cast, JPEG and PNG encode): " + ", ".join(
        f"{bid} {x:.3f}" for bid, x in out["harness"]["materialize_s_per_pano"].items()))

    # Card against CPU: the card's checkpoint scored on the CPU, and Stage D on the CPU from the card's preds.
    args = e2e.build_parser().parse_args(argv)
    cfg = e2e.training_config(args, run_dir)
    cpu_preds = root / "e2e_cpu_preds"
    t0 = time.perf_counter()
    train_loop.evaluate(cfg, v["ckpt"], "test", str(cpu_preds), device="cpu")
    cpu_eval_s = time.perf_counter() - t0
    worst, compared, flips = 0.0, 0, 0
    files = sorted(p.name for p in (run_dir / "preds").glob("batch_*.json"))
    if not files or files != sorted(p.name for p in cpu_preds.glob("batch_*.json")):
        raise AssertionError(f"phase 11: batch files on the card {files}, on the CPU {sorted(cpu_preds.iterdir())}")
    for name in files:
        g, c = (json.loads((d / name).read_text()) for d in (run_dir / "preds", cpu_preds))
        if g["fp0"] != c["fp0"] or g["y_true"] != c["y_true"]:
            raise AssertionError(f"phase 11: {name}: the card's and the CPU's tuples differ")
        p_card = np.where(np.array(g["y_hat"]) == 1, g["y_hat_probs"], 1 - np.array(g["y_hat_probs"]))
        p_cpu = np.where(np.array(c["y_hat"]) == 1, c["y_hat_probs"], 1 - np.array(c["y_hat_probs"]))
        worst = max(worst, float(np.abs(p_card - p_cpu).max()))
        clear = np.abs(p_cpu - 0.5) > 1e-3
        compared += int(clear.sum())
        flips += int((np.array(g["y_hat"])[clear] != np.array(c["y_hat"])[clear]).sum())
    log(f"phase 11: evaluate of the card's checkpoint on the CPU ({cpu_eval_s:.1f} s): class-1 probabilities at most "
        f"{worst:.3e} apart; labels differ on {flips} of the {compared} tuples clear of 0.5 by 1e-3")
    if worst > 1e-3 or flips:
        raise AssertionError("phase 11: the card's verifier disagrees with the CPU's")
    t0 = time.perf_counter()
    stage_d = e2e.main(["--src_zind_dir", str(src), "--output_dir", str(run_dir), "--stage_d_only",
                        "--confidence_threshold", repr(summary["confidence_threshold"]), "--device", "cpu"])
    cpu_d_s = time.perf_counter() - t0
    for g, c in zip(rows, stage_d["reconstruction"]):
        same = all(g[k] == c[k] for k in ("building_id", "floor_id", "percent_panos_localized", "floorplan_iou",
                                          "percent_in_top2_ccs", "percent_in_top3_ccs"))
        for k in ("avg_abs_rot_err_deg", "avg_abs_trans_err"):
            same &= (g[k] is None) == (c[k] is None) and (g[k] is None or abs(g[k] - c[k]) <= 1e-6)
        if not same or len(rows) != len(stage_d["reconstruction"]):
            raise AssertionError(f"phase 11: Stage D on the CPU from the card's predictions: {c}, card {g}")
    out["cpu_check"] = {"eval_s": cpu_eval_s, "prob_max_diff": worst, "compared": compared, "stage_d_s": cpu_d_s}
    log(f"phase 11: --stage_d_only on the CPU from the card's preds ({cpu_d_s:.1f} s): the same rows, pose errors "
        "within 1e-6")

    # The training stage again, from the same seed and corpus: the training
    # policy makes its checkpoint and the held-out probabilities the first
    # run's, bit for bit.
    out["repeat"] = repeat_training_stage(dev, dataclasses.replace(cfg, model_save_dirpath=str(root / "e2e_repeat")),
                                          Path(v["ckpt"]), run_dir / "preds", root / "e2e_repeat_preds")

    # (a') The materializer's provider branch: phase 10's PanoDepthNet, in float32, on the eval building's panos.
    out["provider"] = provider_check(dev, root, src, raw, depth_ckpt)
    # (b) Semantic renders, the z-order and interpolation helpers on phase 3's panos.
    out["semantics"] = semantics_check(dev)
    # (c) ICP between two panos of one room of the eval building.
    out["icp"] = icp_check(dev, root, raw, run_dir / "depth")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 11: {out['seconds']:.1f} s")
    return out


def repeat_training_stage(dev, cfg, ckpt: Path, preds: Path, repeat_preds: Path) -> dict:
    """Phase 11: `train()` and `evaluate()` again on the harness's corpus and
    config (a fresh output directory), against the harness's checkpoint
    `ckpt` and its held-out predictions `preds`: every checkpoint entry and
    every batch file must be equal."""
    import torch

    from salve_tpu_torch.training import loop as train_loop

    t0 = time.perf_counter()
    results = train_loop.train(cfg, device=dev)
    ckpts = sorted(Path(cfg.model_save_dirpath).glob("*/train_ckpt.pt"))
    train_loop.evaluate(cfg, str(ckpts[-1]), "test", str(repeat_preds), device=dev)
    secs = time.perf_counter() - t0

    def entries(obj, prefix=""):
        if isinstance(obj, dict):
            for k, v in obj.items():
                yield from entries(v, f"{prefix}{k}/")
        else:
            yield prefix, obj

    first, again = (dict(entries(torch.load(f, map_location="cpu", weights_only=True))) for f in (ckpt, ckpts[-1]))
    unequal = [k for k in first if not (torch.equal(first[k], again[k]) if torch.is_tensor(first[k])
                                        else first[k] == again[k])]
    files = sorted(p.name for p in preds.glob("batch_*.json"))
    differ = [n for n in files if json.loads((preds / n).read_text()) != json.loads((repeat_preds / n).read_text())]
    n_probs = sum(len(json.loads((preds / n).read_text())["y_hat_probs"]) for n in files)
    row = {"seconds": secs, "entries": len(first), "unequal": len(unequal), "batch_files": len(files),
           "differing_files": len(differ), "val_mAcc": results["val_mAcc"]}
    log(f"phase 11: the training stage again from the same seed ({secs:.1f} s, val mAcc by epoch "
        f"{[round(x, 4) for x in results['val_mAcc']]}): {len(first)} checkpoint entries, {len(unequal)} unequal; "
        f"{len(files)} held-out batch files ({n_probs} probabilities), {len(differ)} differ")
    if unequal or set(first) != set(again) or not files or differ or \
            sorted(p.name for p in repeat_preds.glob("batch_*.json")) != files:
        raise AssertionError(f"phase 11: the repeated training stage differs: checkpoint entries {unequal[:6]}, "
                             f"batch files {differ[:6]}")
    return row


def compare_reports(what: str, card, cpu) -> float:
    """Floor reports of the card against the CPU's: the same floors, % localized
    and IoU equal, pose errors within 1e-6; returns the largest error gap."""
    worst = 0.0
    if len(card) != len(cpu) or not card:
        raise AssertionError(f"{what}: {len(card)} reports on the card, {len(cpu)} on the CPU")
    for g, c in zip(card, cpu):
        gaps = [abs(getattr(g, k) - getattr(c, k)) for k in ("avg_abs_rot_err", "avg_abs_trans_err")]
        worst = max([worst] + gaps)
        if ((g.building_id, g.floor_id, g.percent_panos_localized, g.floorplan_iou)
                != (c.building_id, c.floor_id, c.percent_panos_localized, c.floorplan_iou) or not max(gaps) <= 1e-6):
            raise AssertionError(f"{what}: floor {c.building_id} {c.floor_id}: card {g}, CPU {c}")
    return worst


def run_cli(module, argv, max_lines: int = 8) -> str:
    """A CLI's `main(argv)` in this process; it must return or exit 0. Its
    standard output is returned, and its first `max_lines` lines logged."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            module.main(argv)
        except SystemExit as e:
            if e.code not in (0, None):
                raise AssertionError(f"phase 12: {module.__name__} exited {e.code}") from e
    text = buf.getvalue()
    name = module.__name__.rsplit(".", 1)[-1]
    lines = [line.rstrip() for line in text.splitlines() if line.strip()]
    for line in lines[:max_lines]:
        log(f"phase 12: {name}: {line}")
    if len(lines) > max_lines:
        log(f"phase 12: {name}: ... {len(lines) - max_lines} more lines")
    return text


def evaluation_phase(dev, root: Path, e2e_dir: Path) -> dict:
    """Phase 12: the oracle-pose floorplan evaluation, the SfM baselines and
    the analysis CLIs (module docstring)."""
    import torch

    from salve_tpu_torch import device as device_mod
    from salve_tpu_torch.baselines.sfm_eval import analyze_algorithm_results
    from salve_tpu_torch.cli import (analyze_predictions, compute_average_zind_stats, estimate_completion_percent,
                                     eval_floorplan, evaluate_sfm_baseline, measure_acc_vs_overlap,
                                     sanity_check_gt_pose_graphs)
    from salve_tpu_torch.common import posegraph2d
    from salve_tpu_torch.common.floor_reconstruction_report import render_raster_occupancy
    from salve_tpu_torch.dataset import hnet_prediction_loader, seeded_sfm
    from salve_tpu_torch.dataset.seeded_predictions import write_seeded_mhnet_predictions
    from salve_tpu_torch.dataset.zind_partition import DATASET_SPLITS

    t_phase = time.perf_counter()
    card = card_line()
    cpu = torch.device("cpu")
    out = {}
    zind = root / "zind"
    bids = sorted(p.name for p in zind.iterdir())
    device_mod.reset_launch_counts()

    # (a) eval_floorplan: GT poses with seeded MHNet layouts, card against CPU.
    mhnet = root / "mhnet_eval"
    eval_bids = [bid for bid in bids if bid in DATASET_SPLITS[EVAL_SPLIT]]
    for bid in eval_bids:
        write_seeded_mhnet_predictions(mhnet, bid, json.loads((zind / bid / "zind_data.json").read_text()), int(bid))
    t0 = time.perf_counter()
    card_reports = eval_floorplan.main(["--raw_dataset_dir", str(zind), "--mhnet_predictions_data_root", str(mhnet),
                                        "--split", EVAL_SPLIT, "--viz_save_dir", str(root / "oracle_card"),
                                        "--device", dev.type])
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_reports = eval_floorplan.eval_oraclepose_predictedlayout(str(zind), str(mhnet), EVAL_SPLIT,
                                                                 str(root / "oracle_cpu"), device=cpu)
    cpu_s = time.perf_counter() - t0
    gap = compare_reports("phase 12: eval_floorplan", card_reports, cpu_reports)
    out["eval_floorplan"] = {"floors": len(card_reports), "ms_card": 1e3 * card_s / len(card_reports),
                             "ms_cpu": 1e3 * cpu_s / len(cpu_reports), "error_gap": gap,
                             "iou": [r.floorplan_iou for r in card_reports]}
    log(f"phase 12: {card}: eval_floorplan (GT poses, seeded MHNet layouts) over {len(card_reports)} floors of the "
        f"{EVAL_SPLIT} split {eval_bids}: IoU {[round(r.floorplan_iou, 4) for r in card_reports]}, card equals CPU "
        f"(IoU and % localized exactly, errors {gap:.2e} apart); {out['eval_floorplan']['ms_card']:.1f} ms a floor on "
        f"the card, {out['eval_floorplan']['ms_cpu']:.1f} ms on the CPU")

    # The report's device work for the first floor: the RANSAC Sim(3) alone,
    # then the raster IoU alone (torch.profiler: kernels, summed device ms).
    bid = eval_bids[0]
    gt = posegraph2d.get_gt_pose_graph(bid, "floor_01", str(zind))
    inferred = hnet_prediction_loader.load_inferred_floor_pose_graphs(bid, str(zind), str(mhnet))["floor_01"]
    est = posegraph2d.PoseGraph2d.from_aligned_est_poses_and_inferred_layouts(gt, inferred)
    aligned, _ = est.align_by_Sim3_to_ref_pose_graph(ref_pose_graph=gt, device=dev)
    kernels = {"ransac": profiled_kernels(lambda: est.align_by_Sim3_to_ref_pose_graph(ref_pose_graph=gt, device=dev)),
               "raster": profiled_kernels(lambda: render_raster_occupancy(aligned, gt, device=dev))}
    out["report_kernels"] = {k: {"kernels": n, "device_ms": ms} for k, (n, ms) in kernels.items()}
    log(f"phase 12: {card}: floor {bid}'s report on the card (torch.profiler): RANSAC Sim(3) "
        f"{kernels['ransac'][0]} kernels, {kernels['ransac'][1]:.4f} ms summed device time; raster IoU "
        f"{kernels['raster'][0]} kernels, {kernels['raster'][1]:.4f} ms")

    # (b) The SfM baselines on seeded reconstructions of every floor.
    results = root / "sfm_results"
    for bid in bids:
        seeded_sfm.write_opensfm_reconstruction(str(results), str(zind), bid, "floor_01", seed=int(bid))
        seeded_sfm.write_openmvg_reconstruction(str(results), str(zind), bid, "floor_01", seed=int(bid))
    out["sfm"] = {}
    for alg in SFM_ALGORITHMS:
        argv = ["--raw_dataset_dir", str(zind), "--results_dir", str(results), "--algorithm_name", alg]
        t0 = time.perf_counter()
        card_reports = evaluate_sfm_baseline.main(argv + ["--save_dir", str(root / f"sfm_{alg}_card"),
                                                          "--device", dev.type])
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            cpu_reports = evaluate_sfm_baseline.main(argv + ["--save_dir", str(root / f"sfm_{alg}_cpu"),
                                                             "--device", "cpu"])
        cpu_s = time.perf_counter() - t0
        gap = compare_reports(f"phase 12: evaluate_sfm_baseline {alg}", card_reports, cpu_reports)
        summaries = sorted(p.name for p in (root / f"sfm_{alg}_card" / "result_summaries").iterdir())
        same_files = all((root / f"sfm_{alg}_card" / "result_summaries" / n).read_bytes()
                         == (root / f"sfm_{alg}_cpu" / "result_summaries" / n).read_bytes() for n in summaries)
        corpus = analyze_algorithm_results(str(zind), str(root / f"sfm_{alg}_card" / "result_summaries"))
        row = {"floors": len(card_reports), "ms_card": 1e3 * card_s / len(card_reports),
               "ms_cpu": 1e3 * cpu_s / len(cpu_reports), "error_gap": gap, "summary": corpus,
               "rot_err_deg": [r.avg_abs_rot_err for r in card_reports],
               "trans_err_m": [r.avg_abs_trans_err for r in card_reports],
               "localized": [r.percent_panos_localized for r in card_reports],
               "iou": [r.floorplan_iou for r in card_reports]}
        out["sfm"][alg] = row
        log(f"phase 12: {card}: evaluate_sfm_baseline {alg} over {len(card_reports)} seeded reconstructions: "
            f"rotation errors {[round(x, 4) for x in row['rot_err_deg']]} deg, translation errors "
            f"{[round(x, 4) for x in row['trans_err_m']]} m (noise {seeded_sfm.ROT_NOISE_DEG} deg, "
            f"{seeded_sfm.TRANS_NOISE_M} m a pano; bounds {SFM_ROT_BOUND}x, {SFM_TRANS_BOUND}x), localized "
            f"{[round(x, 2) for x in row['localized']]}%, IoU {[round(x, 4) for x in row['iou']]}; card equals CPU "
            f"(errors {gap:.2e} apart, result_summaries equal: {same_files}); {row['ms_card']:.1f} ms a floor on the "
            f"card, {row['ms_cpu']:.1f} ms on the CPU")
        log(f"phase 12: analyze_algorithm_results {alg}: {corpus}")
        if (not same_files or len(summaries) != len(bids)
                or max(row["rot_err_deg"]) >= SFM_ROT_BOUND * seeded_sfm.ROT_NOISE_DEG
                or max(row["trans_err_m"]) >= SFM_TRANS_BOUND * seeded_sfm.TRANS_NOISE_M
                or not 0 < min(row["localized"]) < 100 or corpus["num_floors"] != len(bids)):
            raise AssertionError(f"phase 12: evaluate_sfm_baseline {alg}: {row}")

    # (c) The analysis CLIs on phase 11's harness tree (held-out building).
    raw, hyp, preds, bev = (str(e2e_dir / d) for d in ("zind", "hypotheses", "preds", "bev"))
    eval_bid = E2E_BUILDINGS[1]
    t0 = time.perf_counter()
    texts = {
        "analyze_predictions": run_cli(analyze_predictions, [
            "--preds_dir", preds, "--hypotheses_save_root", hyp, "--raw_dataset_dir", raw, "--building_id", eval_bid,
            "--output_json", str(root / "analyze_predictions.json")]),
        "measure_acc_vs_overlap": run_cli(measure_acc_vs_overlap, [
            "--serialized_preds_json_dir", preds, "--hypotheses_save_root", hyp, "--raw_dataset_dir", raw]),
        "sanity_check_gt_pose_graphs": run_cli(sanity_check_gt_pose_graphs, ["--raw_dataset_dir", raw]),
        "compute_average_zind_stats": run_cli(compute_average_zind_stats, ["--raw_dataset_dir", raw]),
        "estimate_completion_percent": run_cli(estimate_completion_percent, [
            "--hypotheses_save_root", hyp, "--bev_save_root", bev]),
    }
    out["clis_s"] = time.perf_counter() - t0
    expect = {"analyze_predictions": "hyp recall", "measure_acc_vs_overlap": "overlap IoU",
              "sanity_check_gt_pose_graphs": "failed.", "compute_average_zind_stats": "Avg panos/floor",
              "estimate_completion_percent": f"Building {eval_bid} Pos."}
    missing = [k for k, v in expect.items() if v not in texts[k]]
    if missing or "0 failed." not in texts["sanity_check_gt_pose_graphs"]:
        raise AssertionError(f"phase 12: the analysis CLIs' summaries lack {missing}")
    log(f"phase 12: the analysis CLIs on phase 11's tree exited 0 with their summaries in {out['clis_s']:.1f} s")

    out["launches"] = device_mod.launch_counts()
    log(f"phase 12: launches of B1-B3 over the phase (its device work is the RANSAC and the raster, plain torch): "
        f"{out['launches']}")
    if any(out["launches"].values()):
        raise AssertionError(f"phase 12: the evaluation path launched {out['launches']}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 12: {out['seconds']:.1f} s")
    return out


def provider_check(dev, root: Path, src: Path, raw: Path, depth_ckpt: Path) -> dict:
    """Phase 11 (a'): `materialize_synthetic_building` with a depth provider
    reading the eval building's existing panos, card against CPU."""
    import numpy as np
    import torch

    from salve_tpu_torch.dataset.synthetic_zind import materialize_synthetic_building
    from salve_tpu_torch.models.depth_net import load_depth_provider
    from salve_tpu_torch.native import png

    bid = E2E_BUILDINGS[1]
    payload = torch.load(depth_ckpt, map_location="cpu", weights_only=True)
    payload["config"]["compute_dtype"] = "float32"
    ckpt = root / "depth_net" / "fixed_float32.pt"
    torch.save(payload, ckpt)
    card_root, cpu_root = root / "e2e_depth_card", root / "e2e_depth_cpu"
    provider = load_depth_provider(str(ckpt), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    materialize_synthetic_building(str(src), bid, str(raw), depth_save_root=str(card_root), depth_provider=provider)
    secs = time.perf_counter() - t0
    maps = sorted((card_root / bid).glob("*.depth.png"))
    n = len(list((raw / bid / "panos").glob("*.jpg")))
    if len(maps) != n:
        raise AssertionError(f"phase 11: the provider branch wrote {len(maps)} depth maps for {n} panos")
    checked = maps[:E2E_PROVIDER_CHECK_PANOS]
    shutil.copytree(card_root, cpu_root)
    for m in checked:
        (cpu_root / bid / m.name).unlink()
    materialize_synthetic_building(str(src), bid, str(raw), depth_save_root=str(cpu_root),
                                   depth_provider=load_depth_provider(str(ckpt), device="cpu"))
    worst, share = 0, 0.0
    for m in checked:
        a = png.read_png(m).astype(np.int64)
        b = png.read_png(cpu_root / bid / m.name).astype(np.int64)
        worst = max(worst, int(np.abs(a - b).max()))
        share = max(share, float((a != b).mean()))
    row = {"panos": n, "seconds": secs, "s_per_pano": secs / n, "max_mm": worst, "share_apart": share}
    log(f"phase 11: provider branch (phase 10's PanoDepthNet in float32, ResNet-50, 512x1024) over building {bid}'s "
        f"{n} panos on the card in {secs:.2f} s ({row['s_per_pano']:.3f} s a pano: JPEG decode, forward, PNG encode); "
        f"{len(checked)} panos card vs CPU: at most {worst} mm apart, on {100 * share:.4f}% of the pixels")
    if worst > 1 or share > 1e-3:
        raise AssertionError("phase 11: the provider branch's depth on the card disagrees with the CPU's")
    return row


def semantics_check(dev) -> dict:
    """Phase 11 (b): semantic renders of phase 3's panos, the z-order and the
    interpolation helpers, card against CPU."""
    import numpy as np
    import torch

    from salve_tpu_torch import device as device_mod
    from salve_tpu_torch.dataset.synthetic_bank import make_synthetic_pano_bank
    from salve_tpu_torch.ops import bev
    from salve_tpu_torch.ops.backproject import FLOOR_Z_RANGE
    from salve_tpu_torch.rendering.bev_pair import BEVRenderConfig, render_identity_batched, surface_clouds
    from salve_tpu_torch.utils import interpolation_utils, zorder_utils

    cpu = torch.device("cpu")
    depths, rgbs = make_synthetic_pano_bank(4, 512, 1024)
    cfg = BEVRenderConfig(img_px=500, is_semantics=True)
    imgs, launches = {}, {}
    for d in (dev, cpu):
        device_mod.reset_launch_counts()
        imgs[d.type] = render_identity_batched(torch.as_tensor(depths, device=d), torch.as_tensor(rgbs, device=d),
                                               FLOOR_Z_RANGE, cfg).cpu().numpy()
        launches[d.type] = device_mod.launch_counts()
    one_b1 = {"splat": 1, "fill": 0, "warp": 0, "layout": 0}
    if not np.array_equal(imgs[dev.type], imgs["cpu"]) or launches[dev.type] != one_b1:
        raise AssertionError(f"phase 11: semantic render: card equals CPU {np.array_equal(imgs[dev.type], imgs['cpu'])}"
                             f", launches {launches[dev.type]}")
    row = {"render_launches": launches[dev.type], "render_nonzero": float((imgs["cpu"] > 0).mean())}

    # One pano's floor cloud on the 501^2 grid: integer cells, heights, colours.
    xyz, c, v = surface_clouds(torch.as_tensor(depths[:1]), torch.as_tensor(rgbs[:1]), FLOOR_Z_RANGE, cfg)
    xy_img, z, rgb255, valid = bev.splat_inputs(xyz, c, v, 500, cfg.meters_per_px)
    keep = (valid & (xy_img >= 0).all(-1) & (xy_img <= 500).all(-1))[0].numpy()
    x, y = xy_img[0, :, 0].numpy()[keep], xy_img[0, :, 1].numpy()[keep]
    zz, cols = z[0].numpy()[keep].astype(np.float64), rgb255[0].numpy()[keep]
    masks = {}
    for d in (dev, cpu):
        device_mod.reset_launch_counts()
        masks[d.type] = zorder_utils.choose_elevated_repeated_vals(x, y, zz, device=d)
        launches[d.type] = device_mod.launch_counts()
    if not np.array_equal(masks[dev.type], masks["cpu"]) or launches[dev.type] != one_b1:
        raise AssertionError(f"phase 11: choose_elevated_repeated_vals: launches {launches[dev.type]}")
    row["zorder"] = {"points": int(len(x)), "winners": int(masks["cpu"].sum()), "launches": launches[dev.type]}
    pts = np.stack([x, y], axis=1).astype(np.float64)
    blank = np.zeros((501, 501, 3), np.uint8)
    sparse = np.zeros((501, 501, 3), np.uint8)
    sparse[y, x] = np.clip(np.round(cols), 0, 255).astype(np.uint8)
    for sem in (False, True):
        got = {d.type: interpolation_utils.interp_dense_grid_from_sparse(blank, pts, cols, 501, 501, sem, device=d)
               for d in (dev, cpu)}
        kept = {d.type: interpolation_utils.remove_hallucinated_content(sparse, got["cpu"], device=d)
                for d in (dev, cpu)}
        if not (np.array_equal(got[dev.type], got["cpu"]) and np.array_equal(kept[dev.type], kept["cpu"])):
            raise AssertionError(f"phase 11: interpolation helpers (is_semantics={sem}): card differs from CPU")
    log(f"phase 11: semantic render of 4 panos at 501^2 (floor): card equals CPU (u8), launches "
        f"{row['render_launches']}; choose_elevated_repeated_vals on {len(x)} points ({row['zorder']['winners']} "
        f"winners): card equals CPU, launches {row['zorder']['launches']}; interp_dense_grid_from_sparse (both "
        "is_semantics) and remove_hallucinated_content: card equals CPU")
    return row


def icp_check(dev, root: Path, raw: Path, depth_root: Path) -> dict:
    """Phase 11 (c): `cli/register_depth_maps_icp.py` on two panos of one
    room of the eval building, card against CPU, and each scale's loop ms."""
    import numpy as np
    import torch

    from salve_tpu_torch.baselines import icp
    from salve_tpu_torch.cli import register_depth_maps_icp as cli

    bid = E2E_BUILDINGS[1]
    rooms = {}
    for p in sorted((raw / bid / "panos").glob("*.jpg")):
        rooms.setdefault(p.stem.split("_pano_")[0], []).append(p)
    p1, p2 = next(ps for ps in rooms.values() if len(ps) >= 2)[:2]
    d1, d2 = (depth_root / bid / f"{p.stem}.depth.png" for p in (p1, p2))
    argv = ["--depth_fpath_1", str(d1), "--rgb_fpath_1", str(p1), "--depth_fpath_2", str(d2), "--rgb_fpath_2", str(p2)]
    Ts, secs = {}, {}
    for d in (dev.type, "cpu"):
        t0 = time.perf_counter()
        Ts[d] = cli.main(argv + ["--save_fpath", str(root / f"icp_{d}.npy"), "--device", d])
        secs[d] = time.perf_counter() - t0
    if dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("phase 11: the ICP's distance products ran with TF32 on")
    rot = float(np.linalg.norm(Ts[dev.type][:3, :3] - Ts["cpu"][:3, :3]))
    trans = float(np.abs(Ts[dev.type][:3, 3] - Ts["cpu"][:3, 3]).max())
    cloud1, cloud2 = (cli.backproject_pano(str(d), str(p), device=dev) for d, p in ((d1, p1), (d2, p2)))
    scale_ms = []
    for radius, iters in zip(icp.VOXEL_RADII, icp.MAX_ITERS):
        src, tgt, src6, tgt6 = icp.colored_scale_inputs(cloud1, cloud2, radius, dev)
        eye, zero = torch.eye(3, device=dev), torch.zeros(3, device=dev)
        run = lambda: icp._icp_colored_scale(src, tgt, src6, tgt6, eye, zero, radius, iters)  # noqa: E731
        run()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        run()
        b.record()
        torch.cuda.synchronize()
        scale_ms.append({"radius": radius, "iters": iters, "points": [len(src), len(tgt)], "ms": a.elapsed_time(b)})
    row = {"pair": [p1.name, p2.name], "rot_frobenius": rot, "trans_max_m": trans, "cli_s": secs,
           "scales": scale_ms}
    log(f"phase 11: register_depth_maps_icp on {p1.stem} -> {p2.stem}: card vs CPU rotation {rot:.3e} (Frobenius), "
        f"translation {trans:.3e} m; the CLI {secs[dev.type]:.2f} s on the card, {secs['cpu']:.2f} s on the CPU; "
        "each scale's loop (CUDA events, host gaps included): " + ", ".join(
            f"{s['radius']} m x {s['iters']} iterations on {s['points']} points {s['ms']:.2f} ms" for s in scale_ms))
    if rot > 1e-4 or trans > 1e-4:
        raise AssertionError("phase 11: the card's ICP disagrees with the CPU's")
    return row


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


def layout_case(rng, n_verts, n_wdos, shift: float = 0.0, reach: float = 4.5, degenerate: bool = False):
    """Padded host layouts (`rendering/layout.py:pack_layouts`'s arrays) of
    seeded star-shaped rooms of `n_verts` vertices, moved by `shift` metres,
    and `n_wdos` W/D/O segments a row with ends uniform in +-`reach`; with
    `degenerate`, each row's first segment a point."""
    import numpy as np

    from salve_tpu_torch.rendering.layout import WDO_COLORS

    palette = np.array(list(WDO_COLORS.values()), np.float32)
    b = len(n_verts)
    verts = np.zeros((b, max(max(n_verts), 1), 2), np.float32)
    segs = np.zeros((b, max(max(n_wdos), 1), 2, 2), np.float32)
    colors = np.zeros(segs.shape[:2] + (3,), np.float32)
    for r, (nv, nw) in enumerate(zip(n_verts, n_wdos)):
        ang = np.sort(rng.uniform(0, 2 * np.pi, nv))
        rad = rng.uniform(1.0, 4.5, nv)
        verts[r, :nv] = np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1) + rng.normal(0, 0.4, 2) + shift
        segs[r, :nw] = rng.uniform(-reach, reach, (nw, 2, 2))
        colors[r, :nw] = palette[rng.integers(len(palette), size=nw)]
        if degenerate and nw:
            segs[r, 0, 1] = segs[r, 0, 0]
    return verts, np.array(n_verts), segs, colors, np.array(n_wdos)


def layout_cases(rng) -> dict:
    """The layout kernel's phase-2 inputs: the layout cell's batch (32 rooms
    of 537-607 vertices, 0-9 W/D/Os a row), the corpus renderer's chunk of
    64, rooms past one staged tile of vertices, more W/D/Os than the kernel
    stages, geometry off the image with degenerate segments, and tiny rooms."""
    cell = lambda b: (rng.integers(537, 608, b).tolist(), rng.integers(0, 10, b).tolist())  # noqa: E731
    return {
        "32x501^2 (the layout cell's batch)": layout_case(rng, *cell(32)),
        "64x501^2 (a corpus chunk)": layout_case(rng, *cell(64)),
        "rooms of 3000, 1025 and 1024 vertices": layout_case(rng, [3000, 1025, 1024], [2, 0, 5]),
        "70 and 65 W/D/Os": layout_case(rng, [600, 9], [70, 65]),
        "off the image, degenerate segments": layout_case(rng, [580] * 8, list(range(1, 9)), shift=2.5, reach=12.0,
                                                          degenerate=True),
        "rooms of 0-4 vertices": layout_case(rng, [0, 1, 2, 3, 4], [0, 1, 0, 2, 1]),
    }


def layout_inputs(layout, case, dev):
    """The five raster inputs of a case as views of one upload, as the
    scorer's `layout_rasters` makes them."""
    import torch

    packed = torch.as_tensor(layout.pack_layouts(*case), device=dev)
    return layout.unpack_layouts(packed, case[0].shape[1], case[2].shape[1])


def layout_verifier_run(dev, n_panos: int, depths_np, rgbs_np, hyps, batch: int, render_cfg) -> dict:
    """Phase 3's layout verifier: the six-image ResNet-152 (seeded weights,
    bf16) scoring `hyps` in warp mode with a seeded layout a pano, launch
    counts zeroed just before the measured call and read just after."""
    import numpy as np
    import torch

    from salve_tpu_torch import device as device_mod
    from salve_tpu_torch.common.wdo import WDO
    from salve_tpu_torch.geometry.sim2 import Sim2
    from salve_tpu_torch.models.early_fusion import EarlyFusionCEResnet
    from salve_tpu_torch.pipeline import fused_inference
    from salve_tpu_torch.training.config import TrainingConfig

    cfg = TrainingConfig(num_layers=152, resize_h=234, resize_w=234, train_h=224, train_w=224, batch_size=batch,
                         modalities=("ceiling_rgb_texture", "floor_rgb_texture", "layout"), compute_dtype="bfloat16")
    torch.manual_seed(3)
    model = EarlyFusionCEResnet(num_layers=cfg.num_layers, modalities=cfg.modalities, compute_dtype=cfg.compute_dtype)
    rng = np.random.default_rng(3)
    verts, n_verts, segs, _, n_wdos = layout_case(rng, rng.integers(537, 608, n_panos).tolist(),
                                                  rng.integers(0, 10, n_panos).tolist())
    kinds = ("doors", "windows", "openings")
    layouts = [(verts[r, :n_verts[r]].astype(np.float64),
                [WDO(Sim2.identity(), tuple(segs[r, k, 0]), tuple(segs[r, k, 1]), 0.0, 2.0, kinds[k % 3])
                 for k in range(n_wdos[r])]) for r in range(n_panos)]
    id2row = {p: p for p in range(n_panos)}

    def score(hs):
        return fused_inference.score_floor_hypotheses(model, cfg, depths_np, rgbs_np, id2row, hs, batch, render_cfg,
                                                      use_warp_renders=True, device=dev, layouts=layouts)

    score(hyps[:batch])  # warm-up: cuDNN plans, the allocator, the verifier's graph
    fused_inference._BANK_GRAPHS.clear()  # as the RGB runs: the measured floor captures its banks' graph
    device_mod.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = score(hyps)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = device_mod.launch_counts()
    if len(res) != len(hyps) or not all(r.y_hat in (0, 1) and 0.0 <= r.prob <= 1.0 for r in res):
        raise AssertionError(f"the layout verifier's results are not one valid score a hypothesis: {res[:4]}")
    log(f"phase 3: layout verifier scored {len(hyps)} hypotheses in {secs:.3f} s ({len(hyps) / secs:.1f} hyp/s), "
        f"rooms of {n_verts.tolist()} vertices and {n_wdos.tolist()} W/D/Os, launches {launches}, "
        f"y_hat=1 share {np.mean([r.y_hat for r in res]):.3f}")
    return {"hypotheses": len(hyps), "seconds": secs, "hyp_per_s": len(hyps) / secs, "launches": launches}


def layout_row(layout, case, inputs, img_px: int, mpp: float) -> dict:
    """The layout kernel on one call's inputs: its time, the plain version's
    and its bound (the u8 rasters written and the inputs read over the
    card's bandwidth, or the crossings over its float32 rate)."""
    b, side = len(case[1]), img_px + 1
    n_bytes = b * side * side * 3 + 8 * int(case[1].sum()) + 28 * int(case[4].sum())
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S, side * int(case[1].sum()) * 4 / FP32_OPS_PER_S
    return {
        "shape": f"{b}x{side}^2, {int(case[1].min())}-{int(case[1].max())} vertices, "
                 f"{int(case[4].min())}-{int(case[4].max())} W/D/Os",
        "ms": time_ms(lambda: layout.rasterize_layout_cuda(*inputs, img_px, mpp)),
        "plain_ms": time_ms(lambda: layout.rasterize_layout_plain(*inputs, img_px, mpp), rounds=3, per_round=2,
                            prefill=False),
        "library_ms": None,
        "bound_ms": max(by_bytes, by_ops) * 1e3,
        "bound_by": "bytes" if by_bytes >= by_ops else "operations",
        "extra": {},
    }


def splat_row(lib, splat, cell, key, ok, side: int, dsmem: float, dev) -> dict:
    """B1 at one shape: its time, the plain and library times on the same
    inputs, and its byte, L2-atomic and DSMEM-atomic bounds (`dsmem`: the
    DSMEM atomicMax rate, a second)."""
    b, n = cell.shape
    hw = side * side
    lib_idx, lib_src = library_splat_inputs(cell, key, ok, hw)
    accepted = int(ok.sum())
    l2 = l2_atomic_rates(lib, b * hw, dev)
    row = {
        "shape": f"{b}x{n} points -> {b}x{side}^2 grid",
        "ms": time_ms(lambda: splat.splat_priority_grid(cell, key, ok, side, side)),
        "plain_ms": time_ms(lambda: splat.splat_priority_grid_plain(cell, key, ok, side, side)),
        "library_ms": time_ms(lambda: library_splat(lib_idx, lib_src, b, hw, dev)),
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


def library_splat_inputs(cell, key, ok, hw: int):
    """B1's library call's inputs on equal work: rejected points sent to a
    sentinel cell a row (masked beforehand)."""
    import torch

    return (torch.where(ok, cell.long(), torch.full_like(cell, hw, dtype=torch.long)),
            torch.where(ok, key, torch.full_like(key, -1)))


def library_splat(lib_idx, lib_src, b: int, hw: int, dev):
    """B1's library call: the grid fill and one scatter_reduce_."""
    import torch

    grid = torch.full((b, hw + 1), -1, dtype=torch.int32, device=dev)
    return grid.scatter_reduce_(1, lib_idx, lib_src, "amax", include_self=True)


def fill_row(fill, args) -> dict:
    """B2 on (sparse, occupied, support): its time, the plain version's and
    its bound (bytes or operations, whichever is larger)."""
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

    from salve_tpu_torch.pipeline.fused_inference import build_banks, place, score_batch

    model = place(model, dev)  # on the card: the verifier replays its graph, as in the scorer
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


def per_rank_kernels(dev, depths, rgbs, banks, render_cfg, n_panos: int) -> dict:
    """Phase 13(c): B1, B2 and B3 at the shapes one rank of a mesh of 2
    gives them (half of the 32-hypothesis batch), each held against its
    plain version and timed beside its bound."""
    import numpy as np
    import torch

    from salve_tpu_torch.ops import bev, fill, splat, warp

    k = MESH_RANK_BATCH
    img_px, mpp = render_cfg.img_px, render_cfg.meters_per_px
    side = img_px + 1
    rng = np.random.default_rng(13)
    xyz, c, v = direct_batch_clouds(rng, depths, rgbs, k, render_cfg)
    cell, key, ok = splat_keys_at(bev, splat, xyz, c, v, img_px, mpp)
    got, ref = splat.splat_priority_grid(cell, key, ok, side, side), splat.splat_priority_grid_plain(cell, key, ok,
                                                                                                     side, side)
    if not torch.equal(got, ref):
        raise AssertionError(f"phase 13: B1 disagrees with its plain version at {k}x{side}^2")
    lib_idx, lib_src = library_splat_inputs(cell, key, ok, side * side)
    out = {"splat": {
        "shape": f"{k}x{cell.shape[1]} points -> {k}x{side}^2 grid (one rank's direct-mode batch)",
        "max_abs_err": max_abs_diff(got, ref),
        "ms": time_ms(lambda: splat.splat_priority_grid(cell, key, ok, side, side)),
        "plain_ms": time_ms(lambda: splat.splat_priority_grid_plain(cell, key, ok, side, side)),
        "library_ms": time_ms(lambda: library_splat(lib_idx, lib_src, k, side * side, dev)),
        "bound_ms": (k * cell.shape[1] * 9 + k * side * side * 4) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
    }}
    args = fill_inputs(bev, splat, xyz, c, v, img_px, mpp)
    got, ref = fill.fill_and_mask(*args), fill.fill_and_mask_plain(*args)
    if not torch.equal(got, ref):
        raise AssertionError(f"phase 13: B2 disagrees with its plain version at {k}x{side}^2")
    out["fill"] = dict(fill_row(fill, args), shape=f"{k}x{side}^2x3 (one rank's direct-mode batch)",
                       max_abs_err=max_abs_diff(got, ref))
    R, t, idx = random_hypotheses(rng, k, n_panos, dev, branches=np.arange(k) % 4)
    params = warp.shear_warp_params(R, t, banks[0].shape[1], img_px, mpp)
    got = warp.warp_banks_auto(banks, R, t, img_px, mpp, bank_idx=idx)
    err = 0.0
    for g, bank in zip(got, banks):
        ref = warp.shear_warp_plain(bank, idx, params)
        if not torch.equal(g, ref):
            raise AssertionError(f"phase 13: B3 disagrees with its plain version at 2x{k} rows")
        err = max(err, max_abs_diff(g, ref))
    branches = [int(x) for x in np.bincount(params.n.cpu().numpy(), minlength=4)]
    if min(branches) == 0:
        raise AssertionError(f"phase 13: rot90 branches {branches}: one is empty")
    out["warp"] = {
        "shape": f"2 banks x {k} rows of {banks[0].shape[1]}^2 -> 2x{k}x{params.d}^2x3 (one rank's batch), "
                 f"rot90 branches {branches}",
        "max_abs_err": err,
        "ms": time_ms(lambda: warp.shear_warp_cuda(banks, idx, params)),
        "plain_ms": time_ms(lambda: [warp.shear_warp_plain(bk, idx, params) for bk in banks]),
        "library_ms": None, "bound_ms": sum(warp_bound_ms(warp, bk, idx, params) for bk in banks),
        "bound_by": "bytes",
    }
    card = card_line()
    for name, row in out.items():
        row["card"] = card
        log(f"phase 13: {name} at {row['shape']}: equal to its plain version (max |diff| {row['max_abs_err']}); "
            f"{row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, library {row['library_ms']}, bound "
            f"{row['bound_ms']:.4f} by {row['bound_by']})")
    return out


def scored_rows(results) -> list:
    return [(r.y_hat, r.prob) for r in results]


def mesh_training_setup(dev, corpus: Path):
    """The released config on phase 8's corpus, one batch of MESH_TRAIN_BATCH
    of its train split (rows as phase 9 draws them) and phase 9's start state."""
    import dataclasses

    import numpy as np
    import torch

    from salve_tpu_torch.dataset.bev_pairs import BEVPairDataset
    from salve_tpu_torch.training import train as train_lib
    from salve_tpu_torch.training.config import load_training_config

    repo = Path(__file__).resolve().parent
    base = dataclasses.replace(load_training_config(str(repo / TRAIN_CONFIG)), data_root=str(corpus),
                               split_overrides=dict(TRAIN_SPLITS), batch_size=MESH_TRAIN_BATCH)
    train_ds = BEVPairDataset("train", base, workers=base.workers)
    rows = np.random.default_rng(0).permutation(len(train_ds))[:MESH_TRAIN_BATCH]
    imgs = torch.from_numpy(train_ds._load_tuples([train_ds.data_list[r] for r in rows]))
    labels = torch.as_tensor(np.array([train_ds.data_list[r][-1] for r in rows]))
    state = train_lib.create_train_state(base, torch.Generator().manual_seed(4), 100, dev)
    return base, imgs, labels, state


def mesh_train_steps(state, step, imgs, labels):
    """MESH_TRAIN_STEPS steps from `state` under the training policy, drawing
    from one generator (seed 5, as phase 9); returns (state, losses)."""
    import torch

    from salve_tpu_torch.device import deterministic_algorithms

    gen = torch.Generator().manual_seed(5)
    losses = []
    with deterministic_algorithms():
        for _ in range(MESH_TRAIN_STEPS):
            state, m = step(state, imgs, labels, gen)
            losses.append(float(m["loss"]))
    return state, losses


def mesh_rank(payload: dict) -> dict:
    """Phase 13(b), one rank of a gloo mesh of 2 on the one card: the
    scorer over this rank's rows (and the one-card scorer on them at the
    per-rank batch), then MESH_TRAIN_STEPS global-batch train steps."""
    import dataclasses

    import numpy as np
    import torch

    from salve_tpu_torch import device as device_mod
    from salve_tpu_torch.dataset.synthetic_bank import make_synthetic_pano_bank
    from salve_tpu_torch.models.early_fusion import EarlyFusionCEResnet
    from salve_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from salve_tpu_torch.pipeline.fused_inference import score_floor_hypotheses
    from salve_tpu_torch.rendering.bev_pair import BEVRenderConfig
    from salve_tpu_torch.training import train as train_lib
    from salve_tpu_torch.training.config import TrainingConfig

    mesh = make_mesh()
    dev = mesh.device
    out = {"rank": mesh.rank, "device": str(dev), "backend": mesh.backend}
    depths, rgbs = make_synthetic_pano_bank(payload["n_panos"], 512, 1024, seed=0)
    cfg = TrainingConfig(**payload["score_cfg"])
    render_cfg = BEVRenderConfig(img_px=payload["img_px"])
    torch.manual_seed(0)
    model = EarlyFusionCEResnet(num_layers=cfg.num_layers, compute_dtype=cfg.compute_dtype)
    hyps = make_hypotheses(N_WARP_HYPS, seed=2, n_panos=payload["n_panos"])
    id2row = {p: p for p in range(payload["n_panos"])}
    b = cfg.batch_size
    for mode, n in MESH_SCORED.items():
        hs = hyps[:n]
        device_mod.reset_launch_counts()
        res = score_floor_hypotheses(model, cfg, depths, rgbs, id2row, hs, b, render_cfg,
                                     use_warp_renders=(mode == "warp"), mesh=mesh)
        torch.cuda.synchronize()
        launches = device_mod.launch_counts()
        mine = []
        for s in range(0, n, b):
            mine += shard_batch(mesh, hs[s : s + b])
        own = score_floor_hypotheses(model, cfg, depths, rgbs, id2row, mine, b // mesh.size, render_cfg,
                                     use_warp_renders=(mode == "warp"), device=dev)
        out[mode] = {"results": scored_rows(res), "own_rows": scored_rows(own), "launches": launches}
    del model
    torch.cuda.empty_cache()

    base = TrainingConfig(**payload["train_cfg"])
    state = train_lib.create_train_state(base, torch.Generator().manual_seed(4), 100, dev)
    state.model.load_state_dict(torch.load(payload["state0"], weights_only=True))
    batch = torch.load(payload["batch"], weights_only=True)
    imgs, labels = shard_batch(mesh, (batch["imgs"].to(dev), batch["labels"].to(dev)))
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, losses = mesh_train_steps(state, train_lib.make_train_step(base, mesh), imgs, labels)
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t0
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["losses"] = losses
    ref = torch.load(payload["state_a"], weights_only=True)
    got = state.model.state_dict()
    digest = hashlib.sha256()
    stats_rel, param_abs, param_abs_large_grad = 0.0, 0.0, 0.0
    grads = {n: p.grad for n, p in state.model.named_parameters()}
    for name in sorted(got):
        t = got[name].detach().cpu()
        digest.update(t.numpy().tobytes())
        diff = (t.double() - ref[name].double()).abs()
        if "running" in name:
            stats_rel = max(stats_rel, float(diff.max()) / (float(ref[name].abs().max()) or 1.0))
        elif name in grads:
            param_abs = max(param_abs, float(diff.max()))
            # Where the last step's gradient is large (as
            # tests/test_torch_training.py:_compare_step selects), Adam's steps
            # follow the gradients' relative difference, not their sign.
            g = grads[name].detach().abs().cpu()
            large = g > 1e-3 * g.max()
            if large.any():
                param_abs_large_grad = max(param_abs_large_grad, float(diff[large].max()))
    out.update(state_sha256=digest.hexdigest(), stats_rel=stats_rel, param_abs=param_abs,
               param_abs_large_grad=param_abs_large_grad)
    return out


def mesh_phase(dev, root: Path, corpus: Path, scored: dict, depths, rgbs, banks, render_cfg) -> dict:
    """Phase 13: more than one rank (module docstring)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from salve_tpu_torch.cli import test_fused
    from salve_tpu_torch.models.early_fusion import EarlyFusionCEResnet
    from salve_tpu_torch.parallel.mesh import launch, make_mesh
    from salve_tpu_torch.pipeline.fused_inference import score_floor_hypotheses
    from salve_tpu_torch.training import train as train_lib
    from salve_tpu_torch.training.config import TrainingConfig

    t_phase = time.perf_counter()
    n_panos = depths.shape[0]
    out = {}
    score_cfg = dict(num_layers=152, resize_h=234, resize_w=234, train_h=224, train_w=224, batch_size=32,
                     compute_dtype="bfloat16")
    cfg = TrainingConfig(**score_cfg)
    depths_np, rgbs_np = depths.cpu().numpy(), rgbs.cpu().numpy()
    hyps = make_hypotheses(N_WARP_HYPS, seed=2, n_panos=n_panos)
    torch.manual_seed(0)
    model = EarlyFusionCEResnet(num_layers=cfg.num_layers, compute_dtype=cfg.compute_dtype)

    # (a) A world of one over NCCL, through the entry points.
    store = root / "nccl_store"
    dist.init_process_group("nccl", init_method=f"file://{store}", world_size=1, rank=0)
    try:
        mesh = make_mesh()
        if (mesh.size, mesh.backend) != (1, "nccl"):
            raise AssertionError(f"phase 13: a world of {mesh.size} over {mesh.backend}")
        a = {}
        for mode, n in MESH_SCORED.items():
            res = score_floor_hypotheses(model, cfg, depths_np, rgbs_np, {p: p for p in range(n_panos)}, hyps[:n],
                                         cfg.batch_size, render_cfg, use_warp_renders=(mode == "warp"), mesh=mesh)
            a[mode] = scored_rows(res)
            if a[mode] != scored[mode][:n]:
                raise AssertionError(f"phase 13: the world of one's {mode} scores differ from phase 3's")
        log(f"phase 13: (a) a world of one over NCCL: score_floor_hypotheses(mesh=make_mesh()) equals phase 3 bit "
            f"for bit over {MESH_SCORED} hypotheses")
        # The CLI with --mesh_devices 1 against the run without the flag.
        hyp_root = root / "hyp_mesh"
        subset_hypotheses(root / "hyp", hyp_root, CORPUS_FLOORS[0], MESH_CLI_HYPS)
        ckpt = root / "mesh_model.pt"
        torch.save(model.state_dict(), ckpt)
        argv = ["--hypotheses_save_root", str(hyp_root), "--raw_dataset_dir", str(root / "zind"),
                "--depth_save_root", str(root / "depth"), "--ckpt_fpath", str(ckpt)]
        trees = {}
        for tag, extra in (("without", []), ("mesh_devices_1", ["--mesh_devices", "1"])):
            test_fused.main(argv + ["--serialization_save_dir", str(root / f"preds_{tag}")] + extra)
            trees[tag] = file_tree(root / f"preds_{tag}")
        if trees["without"] != trees["mesh_devices_1"] or not trees["without"]:
            raise AssertionError("phase 13: test_fused --mesh_devices 1 wrote other files than the run without it")
        log(f"phase 13: (a) test_fused --mesh_devices 1 over {MESH_CLI_HYPS} hypotheses of floor {CORPUS_FLOORS[0]}: "
            f"{len(trees['without'])} batch files, equal byte for byte to the run without the flag")
        # Training steps: the mesh's step on a world of one against the one-card step.
        base, imgs, labels, state0 = mesh_training_setup(dev, corpus)
        imgs_d, labels_d = imgs.to(dev), labels.to(dev)
        runs = {}
        for tag, step in (("one_card", train_lib.make_train_step(base)),
                          ("mesh_1", train_lib.make_train_step(base, mesh))):
            state, losses = mesh_train_steps(copy.deepcopy(state0), step, imgs_d, labels_d)
            runs[tag] = (state_bits(state), losses)
            if tag == "one_card":
                torch.save({k: v.detach().cpu() for k, v in state.model.state_dict().items()}, root / "state_a.pt")
            del state
        unequal = [k for k in runs["one_card"][0] if not torch.equal(runs["one_card"][0][k], runs["mesh_1"][0][k])]
        out["a"] = {"scored": MESH_SCORED, "cli_files": len(trees["without"]), "losses": runs["one_card"][1],
                    "train_tensors": len(runs["one_card"][0]), "train_unequal": len(unequal)}
        log(f"phase 13: (a) {MESH_TRAIN_STEPS} train steps at batch {MESH_TRAIN_BATCH} (ResNet-152, bf16) under the "
            f"policy, mesh_shape (1,) against the one-card step: {len(runs['one_card'][0])} tensors, "
            f"{len(unequal)} unequal; losses {runs['one_card'][1]}")
        if unequal:
            raise AssertionError(f"phase 13: the world of one's train steps differ in {unequal[:6]}")
        torch.save({k: v.detach().cpu() for k, v in state0.model.state_dict().items()}, root / "state0.pt")
        torch.save({"imgs": imgs, "labels": labels}, root / "mesh_batch.pt")
        del runs, state0, imgs_d
    finally:
        dist.destroy_process_group()
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # (b) A world of two over gloo, both ranks on the one card.
    t0 = time.perf_counter()
    payload = {"n_panos": n_panos, "score_cfg": score_cfg, "img_px": render_cfg.img_px,
               "train_cfg": {f: getattr(base, f) for f in base.__dataclass_fields__},
               "state0": str(root / "state0.pt"), "batch": str(root / "mesh_batch.pt"),
               "state_a": str(root / "state_a.pt")}
    ranks = launch(mesh_rank, 2, payload, device=dev, backend="gloo", device_ids=[0, 0])
    secs_b = time.perf_counter() - t0
    b_out = {"seconds": secs_b, "ranks": [{k: r[k] for k in ("device", "backend", "train_s", "peak_memory_gb",
                                                             "losses", "stats_rel", "param_abs")} for r in ranks]}
    k = cfg.batch_size // 2
    for mode, n in MESH_SCORED.items():
        full = ranks[0][mode]["results"]
        if full != ranks[1][mode]["results"] or len(full) != n:
            raise AssertionError(f"phase 13: (b) the ranks' {mode} lists differ")
        for r in ranks:
            own = [row for s in range(0, n, cfg.batch_size) for row in full[s : s + cfg.batch_size][
                r["rank"] * k : (r["rank"] + 1) * k]]
            if r[mode]["own_rows"] != own:
                raise AssertionError(f"phase 13: (b) rank {r['rank']}'s {mode} rows differ from the one-card scorer "
                                     f"at batch {k} over them")
            needed = ("splat", "fill", "warp") if mode == "warp" else ("splat", "fill")
            if any(r[mode]["launches"][name] == 0 for name in needed):
                raise AssertionError(f"phase 13: (b) rank {r['rank']} {mode} launches {r[mode]['launches']}")
        ref = scored[mode][:n]
        p1 = np.array([p if y == 1 else 1.0 - p for y, p in full])
        p1_ref = np.array([p if y == 1 else 1.0 - p for y, p in ref])
        diff = float(np.abs(p1 - p1_ref).max())
        clear = np.abs(p1_ref - 0.5) > MESH_PROB_BOUND
        flips = int(sum(g[0] != r_[0] for g, r_ in zip(full, ref)))
        b_out[mode] = {"prob_max_abs_diff": diff, "y_hat_flips": flips, "clear_of_half": int(clear.sum()),
                       "launches": [r[mode]["launches"] for r in ranks]}
        log(f"phase 13: (b) {mode} mode, {n} hypotheses over 2 gloo ranks on one card: each rank's rows equal the "
            f"one-card scorer at batch {k} bit for bit; against the world of one at batch {cfg.batch_size}: y_hat "
            f"flips {flips} ({int(clear.sum())} of {n} clear of 0.5 by {MESH_PROB_BOUND}), class-1 prob max |diff| "
            f"{diff:.3e}; launches a rank {[r[mode]['launches'] for r in ranks]}")
        if diff > MESH_PROB_BOUND or not np.array_equal((p1 > 0.5)[clear], (p1_ref > 0.5)[clear]):
            raise AssertionError(f"phase 13: (b) {mode} scores beyond the bound of the world of one")
    if ranks[0]["state_sha256"] != ranks[1]["state_sha256"]:
        raise AssertionError("phase 13: (b) the two ranks' train states differ")
    la = np.array(out["a"]["losses"])
    lb = np.array(ranks[0]["losses"])
    loss_rel = float(np.abs(lb - la).max() / np.abs(la).max())
    stats_rel, param_abs, param_large = (ranks[0][k] for k in ("stats_rel", "param_abs", "param_abs_large_grad"))
    b_out.update(loss_rel=loss_rel, stats_rel=stats_rel, param_abs=param_abs, param_abs_large_grad=param_large)
    log(f"phase 13: (b) {MESH_TRAIN_STEPS} global-batch train steps at {MESH_TRAIN_BATCH} (2 x "
        f"{MESH_TRAIN_BATCH // 2}) against (a): losses {ranks[0]['losses']} vs {out['a']['losses']} (max rel "
        f"{loss_rel:.3e}, bound {MESH_LOSS_BOUND:.3e}), running statistics max |diff| / max |stat| {stats_rel:.3e} "
        f"(bound {MESH_STATS_BOUND:.3e}), parameters max |diff| {param_abs:.3e} (bound {MESH_PARAM_BOUND:.3e}), "
        f"{param_large:.3e} where the gradient is over 1e-3 of its tensor's largest; "
        f"both ranks' states equal; per rank {[round(r['train_s'], 3) for r in ranks]} s, peak "
        f"{[round(r['peak_memory_gb'], 2) for r in ranks]} GB; the whole world of two {secs_b:.1f} s")
    if loss_rel > MESH_LOSS_BOUND or stats_rel > MESH_STATS_BOUND or param_abs > MESH_PARAM_BOUND:
        raise AssertionError("phase 13: (b) the world of two's train steps beyond their bounds of (a)")
    out["b"] = b_out

    # (c) The kernels at one rank's shapes.
    out["kernels"] = per_rank_kernels(dev, depths, rgbs, banks, render_cfg, n_panos)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 13: {card_line()}: {out['seconds']:.1f} s")
    return out


def read_batches(preds: Path) -> dict:
    """The `batch_{i}.json` files of `preds` in index order, as one dict of lists."""
    out = {k: [] for k in ("y_hat", "y_true", "y_hat_probs", "fp0", "fp1")}
    for f in sorted(preds.glob("batch_*.json"), key=lambda f: int(f.stem.split("_")[1])):
        data = json.loads(f.read_text())
        for k in out:
            out[k] += data[k]
    return out


def class1_probs(batches: dict):
    import numpy as np

    y, p = np.array(batches["y_hat"]), np.array(batches["y_hat_probs"], dtype=np.float64)
    return np.where(y == 1, p, 1.0 - p)


def chain_phase(dev, root: Path, verifier_ckpt: Path, hohonet_ckpt: Path, e2e_dir: Path) -> dict:
    """Phase 15: the paper's inference chain through the port's CLIs (module
    docstring). `root` holds phase 8's ZInD tree and depth PNGs,
    `verifier_ckpt` is phase 9's checkpoint, `hohonet_ckpt` phase 10's
    seeded `.pth` and `e2e_dir` phase 11's harness tree (its held-out
    building, ground-truth depth and ResNet-18 checkpoint)."""
    import numpy as np
    import torch

    from salve_tpu_torch import device as device_mod
    from salve_tpu_torch.cli import batch_hohonet_inference, export_alignment_hypotheses, test_fused
    from salve_tpu_torch.cli.run_sfm import run_incremental_reconstruction
    from salve_tpu_torch.cli.stitch_floor_plan import stitch_building_layouts
    from salve_tpu_torch.dataset import seeded_stitching
    from salve_tpu_torch.native import png
    from salve_tpu_torch.pipeline import fused_inference
    from salve_tpu_torch.utils import profiler

    t_phase = time.perf_counter()
    card = card_line()
    cpu = torch.device("cpu")
    work = root / "chain"
    sides = (("card", dev), ("cpu", cpu))
    out = {"seconds_card": {}, "seconds_cpu": {}, "launches": {}, "predicted": {}, "arms": {}}

    def timed(side, stage, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        out[f"seconds_{side}"][stage] = time.perf_counter() - t0
        return got

    def took(stage):
        return f"card {out['seconds_card'][stage]:.2f} s, CPU {out['seconds_cpu'][stage]:.2f} s"

    # 1. W/D/O hypotheses from the ground truth, through the exporter's CLI.
    def export(zind, bid):
        hyp = {side: work / f"hyp_{bid}_{side}" for side, _ in sides}
        for side, d in sides:
            timed(side, f"hypotheses_{bid}", lambda: export_alignment_hypotheses.main([
                "--raw_dataset_dir", str(zind), "--hypotheses_save_root", str(hyp[side]), "--wdo_source",
                "ground_truth", "--split", "test", "--building_id", bid, "--num_processes", "1", "--device", d.type]))
        trees = {side: file_tree(hyp[side]) for side in hyp}
        # Hypotheses a floor in the two label directories test_fused.py scores.
        counts = {}
        for name in trees["card"]:
            _, floor, label, _ = name.split("/")
            if label in ("gt_alignment_approx", "incorrect_alignment"):
                counts[floor] = counts.get(floor, 0) + 1
        if trees["card"] != trees["cpu"] or not counts:
            raise AssertionError(f"phase 15: building {bid}'s hypothesis files differ between the card and the CPU")
        log(f"phase 15: (1) export_alignment_hypotheses --wdo_source ground_truth, building {bid}: "
            f"{len(trees['card'])} files, {counts} to score; card = CPU byte for byte ({took(f'hypotheses_{bid}')})")
        return hyp["card"], counts

    # The arms: (a) the released width (test_fused's defaults: ResNet-152,
    # resize 234, crop 224, batch 32) with phase 9's checkpoint on phase 8's
    # depth PNGs, (b) the same on the cache stage 2 fills, (c) phase 11's
    # verifier on its held-out building; each with warp renders (the CPU's
    # default is direct renders).
    zind_c, bid_c = e2e_dir / "zind", E2E_BUILDINGS[1]
    depth_b = work / "depth_hohonet"
    harness_run = json.loads((e2e_dir / "end_to_end_eval.json").read_text())
    hyp_a, counts_a = export(root / "zind", CHAIN_FLOOR)
    hyp_c, counts_c = export(zind_c, bid_c)
    arms = {"a": (CHAIN_FLOOR, root / "zind", hyp_a, counts_a, root / "depth", verifier_ckpt, []),
            "b": (CHAIN_FLOOR, root / "zind", hyp_a, counts_a, depth_b, verifier_ckpt, []),
            "c": (bid_c, zind_c, hyp_c, counts_c, e2e_dir / "depth", sorted((e2e_dir / "ckpts").glob(
                "*/train_ckpt.pt"))[-1], ["--num_layers", "18", "--resize_px", "128", "--crop_px", "112"])}
    # Stage D in the frozen configuration (module docstring, phase 6); arm (c)
    # in the one phase 11's harness froze on its val building for its verifier.
    frozen = dict(method="pose2_slam", confidence_threshold=STAGE_D_THRESHOLD, rescue_clusters=True)
    configs = {"a": frozen, "b": frozen, "c": dict(
        method=harness_run["method"], confidence_threshold=harness_run["confidence_threshold"],
        rescue_clusters=harness_run["rescue_clusters"], filter_edges_by_global_local_consistency=harness_run["glc"],
        resolve_rot_conflicts=harness_run["rotfix"])}
    notes = {
        "a": "phase 9's checkpoint has had 4 steps, and these panos (synthetic_bank) are not ray-cast from the "
             "floor's rooms, so no verifier could tell a true alignment here",
        "b": "arm (b)'s depth is a seeded HoHoNet's: its renders, scores, poses and IoU mean nothing until "
             "HoHoNet's released ep60.pth is in the repository",
        "c": f"phase 11's verifier on its held-out building {bid_c} (panos ray-cast from its rooms); the harness's "
             "own rows, from its JPEG corpus: " + "; ".join(
                 f"{r['floor_id']} localized {r['percent_panos_localized']:.2f}%, IoU {r['floorplan_iou']:.6f}"
                 for r in harness_run["reconstruction"]),
    }

    def fused_argv(arm, hyp, preds, device):
        bid, zind, _, _, depth_root, ckpt, flags = arms[arm]
        return ["--raw_dataset_dir", str(zind), "--depth_save_root", str(depth_root), "--ckpt_fpath", str(ckpt),
                "--building_id", bid, "--use_warp_renders", *flags, "--hypotheses_save_root", str(hyp),
                "--serialization_save_dir", str(preds), "--device", device]

    # The CPU scores each arm's first hypotheses beside the card's chain: one
    # process an arm (`python -m salve_tpu_torch.cli.test_fused ... --device
    # cpu`, as a user runs it), started as soon as its inputs exist, each on
    # a share of the host's cores.
    repo = Path(__file__).resolve().parent
    threads = str(-(-(os.cpu_count() or 8) // len(arms)))
    cpu_runs = {}
    waiter = concurrent.futures.ThreadPoolExecutor(len(arms))

    def start_cpu_scoring(arm):
        bid, _, hyp, _, _, _, _ = arms[arm]
        prefix = work / f"hyp_{bid}_prefix"
        if not prefix.exists():
            subset_hypotheses(hyp, prefix, bid, CHAIN_CPU_HYPS)
        log_f = open(work / f"cpu_scoring_{arm}.log", "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", "salve_tpu_torch.cli.test_fused", *fused_argv(arm, prefix, work / f"preds_{arm}_cpu",
                                                                               "cpu")],
            cwd=repo, env=dict(os.environ, OMP_NUM_THREADS=threads), stdout=log_f, stderr=subprocess.STDOUT)
        cpu_runs[arm] = (proc, time.perf_counter(), log_f, waiter.submit(lambda: (proc.wait(), time.perf_counter())))

    try:
        start_cpu_scoring("a")
        start_cpu_scoring("c")

        # 2. The depth cache: HoHoNet (phase 10's seeded .pth, 512x1024,
        # float32) over the floor's panos on the card; the CPU fills a cache
        # of the first two.
        panos = sorted((root / "zind" / CHAIN_FLOOR / "panos").glob("*.jpg"))
        sub = work / "zind_cpu"
        (sub / CHAIN_FLOOR / "panos").mkdir(parents=True)
        for f in panos[:DEPTH_CHECK_PANOS]:
            shutil.copy(f, sub / CHAIN_FLOOR / "panos" / f.name)
        for (side, d), zind, depth_root, want in zip(sides, (root / "zind", sub), (depth_b, work / "depth_hohonet_cpu"),
                                                     (len(panos), DEPTH_CHECK_PANOS)):
            ready = timed(side, "depth", lambda: batch_hohonet_inference.main([
                "--raw_dataset_dir", str(zind), "--depth_save_root", str(depth_root), "--building_id", CHAIN_FLOOR,
                "--model_ckpt", str(hohonet_ckpt), "--device", d.type]))
            if ready != (want, 0):
                raise AssertionError(f"phase 15: batch_hohonet_inference on the {side} returned {ready} for {want} "
                                     "panos")
        start_cpu_scoring("b")
        worst_mm, off, n = 0, 0, 0
        for f in panos[:DEPTH_CHECK_PANOS]:
            a, b = (png.read_png(d / CHAIN_FLOOR / f"{f.stem}.depth.png").astype(np.int64)
                    for d in (depth_b, work / "depth_hohonet_cpu"))
            worst_mm, off, n = max(worst_mm, int(np.abs(a - b).max())), off + int((a != b).sum()), n + a.size
        out["depth"] = {"panos": len(panos), "max_mm": worst_mm, "off_share": off / n}
        log(f"phase 15: (2) batch_hohonet_inference over floor {CHAIN_FLOOR}'s {len(panos)} panos on the card, "
            f"{DEPTH_CHECK_PANOS} on the CPU: u16 maps at most {worst_mm} mm apart on {100 * off / n:.4f}% of the "
            f"pixels (phase 10's bound: 1 mm on 0.1%) ({took('depth')})")
        if worst_mm > 1 or off / n > 1e-3:
            raise AssertionError(f"phase 15: the card's depth cache disagrees with the CPU's: {out['depth']}")

        # 3-5 on the card, each arm: test_fused, Stage D on the card's batch
        # files on the card and the CPU, and for arm (c) stitching.
        for arm, (bid, zind, hyp, counts, _, _, flags) in arms.items():
            row = out["arms"][arm] = {"building": bid, "floors": counts, "stage_d": configs[arm]}
            # Phase 3's rule in warp mode: B1 and B2 once a bank (identity and
            # extended, ceiling and floor: 4 a floor), B3 once a batch of 32.
            # A floor's banks replay one CUDA graph a pano count (up to 8
            # panos; larger floors run them eagerly): the floor that captures
            # it launches B1 and B2 twice a bank (its eager run and the
            # capture), a replaying floor none.
            fused_inference._BANK_GRAPHS.clear()
            device_mod.reset_launch_counts()
            banks0 = {k: profiler.counter(f"banks/{k}") for k in ("graph_captures", "graph_replays", "eager")}
            timed("card", f"scoring_{arm}", lambda: test_fused.main(fused_argv(arm, hyp, work / f"preds_{arm}_card",
                                                                                "cuda")))
            banks = {k: profiler.counter(f"banks/{k}") - n for k, n in banks0.items()}
            if banks["graph_replays"] + banks["eager"] != len(counts) or banks["graph_captures"] > banks["graph_replays"]:
                raise AssertionError(f"phase 15: ({arm}) {len(counts)} floors built their banks as {banks}")
            bank_launches = 8 * banks["graph_captures"] + 4 * banks["eager"]
            predicted = {"splat": bank_launches, "fill": bank_launches,
                         "warp": sum(-(-c // 32) for c in counts.values()), "layout": 0}
            out["launches"][arm], out["predicted"][arm] = device_mod.launch_counts(), predicted
            log(f"phase 15: (3{arm}) test_fused ({'ResNet-18, 128 / 112' if flags else 'ResNet-152, 234 / 224'}, "
                f"bf16, batch 32, warp renders) over building {bid}'s {sum(counts.values())} hypotheses in "
                f"{out['seconds_card'][f'scoring_{arm}']:.2f} s: launches {out['launches'][arm]}, predicted {predicted}")
            if out["launches"][arm] != predicted:
                raise AssertionError(f"phase 15: ({arm}) launches {out['launches'][arm]}, predicted {predicted}")
            reports = {}
            for side, d in sides:
                reports[side] = timed(side, f"stage_d_{arm}", lambda: run_incremental_reconstruction(
                    hypotheses_save_root=str(hyp), serialized_preds_json_dir=str(work / f"preds_{arm}_card"),
                    raw_dataset_dir=str(zind), allowed_wdo_types=STAGE_D_WDO_TYPES, use_axis_alignment=False,
                    predictions_data_root=None, plot_save_dir=str(work / f"sfm_{arm}_{side}"), device=d,
                    **configs[arm]))
            worst = compare_stage_d_runs(f"phase 15 ({arm})", reports["card"], reports["cpu"],
                                         work / f"sfm_{arm}_card_serialized", work / f"sfm_{arm}_cpu_serialized")
            row["reports"] = [{"floor": r.floor_id, "localized_pct": r.percent_panos_localized,
                               "iou": r.floorplan_iou, "rot_err_deg": r.avg_abs_rot_err,
                               "trans_err_m": r.avg_abs_trans_err} for r in reports["card"]]
            row.update(worst_error_diff=worst["errors"], worst_pose_diff=worst["poses"])
            log(f"phase 15: (4{arm}) Stage D ({configs[arm]}) on the card's batch files: " + "; ".join(
                f"{bid} {r['floor']} localized {r['localized_pct']:.2f}%, IoU {r['iou']:.6f}" for r in row["reports"])
                + f"; card = CPU (errors within {worst['errors']:.1e}, poses within {worst['poses']:.1e}; "
                f"{took(f'stage_d_{arm}')}); {notes[arm]}")
            if arm != "c":
                continue
            seeded_stitching.write_layout_predictions(
                work / "layouts", bid, json.loads((zind / bid / "zind_data.json").read_text()), E2E_BASE_SEED)
            sers = sorted((work / "sfm_c_card_serialized").glob(f"{bid}__*.json"))
            if not sers:
                raise AssertionError(f"phase 15: Stage D localized no pano of building {bid}: no poses to stitch")
            row["stitched_groups"] = {}
            for ser in sers:
                stitched = {}
                for side, d in sides:
                    stitched[side] = timed(side, f"stitching_{ser.stem}", lambda: stitch_building_layouts(
                        bid, str(work / "layouts"), str(zind), str(ser), str(work / f"stitch_{side}_{ser.stem}"),
                        device=d))
                (shapes, rings), (shapes_cpu, rings_cpu) = stitched["card"], stitched["cpu"]
                if fused_key(shapes) != fused_key(shapes_cpu) or not all(
                        np.array_equal(x, y) for g, h in zip(rings, rings_cpu) for x, y in zip(g, h)):
                    raise AssertionError(f"phase 15: (5) a stitched shape of {ser.stem} differs between the card and "
                                         "the CPU")
                row["stitched_groups"][ser.stem] = [len(g) for g in shapes]
                log(f"phase 15: (5) stitch_building_layouts on {ser.stem}'s card poses and seeded layouts: room "
                    f"groups {row['stitched_groups'][ser.stem]}, card = CPU (fused shapes and rings bit for bit; "
                    f"{took(f'stitching_{ser.stem}')})")

        # 3, the CPU's side: each arm's first hypotheses against the card's.
        for arm, (proc, started, log_f, waited) in cpu_runs.items():
            rc, ended = waited.result(timeout=600)
            out["seconds_cpu"][f"scoring_{arm}"] = ended - started
            if rc != 0:
                log_f.flush()
                raise AssertionError(f"phase 15: ({arm}) test_fused on the CPU exited {rc}: "
                                     + (work / f"cpu_scoring_{arm}.log").read_text()[-3000:])
            got, ref = read_batches(work / f"preds_{arm}_card"), read_batches(work / f"preds_{arm}_cpu")
            counts, row = arms[arm][3], out["arms"][arm]
            k = len(ref["y_hat"])
            if len(got["y_hat"]) != sum(counts.values()) or k != min(CHAIN_CPU_HYPS, next(iter(counts.values()))):
                raise AssertionError(f"phase 15: ({arm}) {len(got['y_hat'])} scores on the card, {k} on the CPU")
            if [got[f][:k] for f in ("fp0", "fp1", "y_true")] != [ref[f] for f in ("fp0", "fp1", "y_true")]:
                raise AssertionError(f"phase 15: ({arm}) the batch files name other pairs on the card and the CPU")
            p_card, p_cpu = class1_probs(got)[:k], class1_probs(ref)
            diff = float(np.abs(p_card - p_cpu).max())
            clear = np.abs(p_cpu - 0.5) > CHAIN_PROB_BOUND
            y = np.array(got["y_hat"])
            row.update(prob_max_abs_diff=diff, compared=k, clear_of_half=int(clear.sum()),
                       y_hat_flips=int(np.sum((p_card > 0.5) != (p_cpu > 0.5))), positive_share=float(np.mean(y)),
                       above_threshold=int(np.sum((y == 1) & (np.array(got["y_hat_probs"]) >= STAGE_D_THRESHOLD))),
                       verifier_acc=float(np.mean(y == np.array(got["y_true"]))))
            log(f"phase 15: (3{arm}) card against CPU on the first {k} hypotheses (the CPU's process "
                f"{out['seconds_cpu'][f'scoring_{arm}']:.2f} s on {threads} threads): class-1 probabilities max |diff| "
                f"{diff:.3e} (bound {CHAIN_PROB_BOUND}), y_hat flips {row['y_hat_flips']} ({row['clear_of_half']} "
                f"clear of 0.5 by the bound); on the card y_hat = 1 for {100 * row['positive_share']:.1f}%, "
                f"{row['above_threshold']} positives at or above {STAGE_D_THRESHOLD}, labels right for "
                f"{100 * row['verifier_acc']:.1f}%")
            if diff > CHAIN_PROB_BOUND or not np.array_equal((p_card > 0.5)[clear], (p_cpu > 0.5)[clear]):
                raise AssertionError(f"phase 15: ({arm}) the card's scores disagree with the CPU's: {row}")
    finally:
        for proc, _, log_f, _ in cpu_runs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            log_f.close()
        waiter.shutdown()

    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 15: {card}: the chain on the card, s by stage: "
        + ", ".join(f"{k} {v:.3f}" for k, v in out["seconds_card"].items())
        + f" (sum {sum(out['seconds_card'].values()):.3f}); the CPU's checks: "
        + ", ".join(f"{k} {v:.3f}" for k, v in out["seconds_cpu"].items())
        + f"; the phase {out['seconds']:.1f} s")
    return out


class _Records(logging.Handler):
    """Keeps the records it is given (phase 14 counts the figures' warnings)."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def single_render_phase(dev, root: Path, depths_np, rgbs_np, stage_d: dict) -> dict:
    """Phase 14: the single-image and single-pair renders on the card, and
    the figures' policy on this machine (module docstring)."""
    import importlib.util

    import numpy as np
    import torch

    from salve_tpu_torch import device as device_mod
    from salve_tpu_torch.cli import visualize_backprojected_depthmap as depthmap_cli
    from salve_tpu_torch.cli import visualize_floorplans_side_by_side_baselines as baselines_cli
    from salve_tpu_torch.cli.run_sfm import run_incremental_reconstruction
    from salve_tpu_torch.common.posegraph2d import get_gt_pose_graph
    from salve_tpu_torch.dataset import seeded_sfm
    from salve_tpu_torch.geometry.sim2 import Sim2
    from salve_tpu_torch.ops import bev, fill, splat
    from salve_tpu_torch.ops.backproject import CEILING_Z_RANGE, FLOOR_Z_RANGE, backproject_depth
    from salve_tpu_torch.rendering import bev_pair, layout
    from salve_tpu_torch.utils import plotting

    t_phase = time.perf_counter()
    card = card_line()
    cpu = torch.device("cpu")
    have = {m: importlib.util.find_spec(m) is not None for m in ("matplotlib", "PIL")}
    out = {"installed": have, "launches": {}, "kernels": {}}
    log(f"phase 14: matplotlib {'installed' if have['matplotlib'] else 'absent'}, PIL "
        f"{'installed' if have['PIL'] else 'absent'}: the figures' "
        + ("drawn branch" if have["matplotlib"] else "absent branch (rule (a) raises, rule (b) leaves figures out)"))

    def launched(fn):
        device_mod.reset_launch_counts()
        got = fn()
        torch.cuda.synchronize()
        return got, device_mod.launch_counts()

    def expect_one_each(what, counts):
        if counts != {"splat": 1, "fill": 1, "warp": 0, "layout": 0}:
            raise AssertionError(f"phase 14: {what} launched {counts}, not one B1 and one B2")

    # (a) render_bev_image on pano 0 at 501^2, both surfaces.
    d0 = torch.as_tensor(depths_np[:1].astype(np.float32), device=dev)
    c0 = torch.as_tensor(rgbs_np[:1], device=dev)
    for surface, zr in (("floor", FLOOR_Z_RANGE), ("ceiling", CEILING_Z_RANGE)):
        xyz, col, val = backproject_depth(d0, c0, zr)
        got, counts = launched(lambda: bev.render_bev_image(xyz[0], col[0], val[0]))
        expect_one_each(f"render_bev_image ({surface})", counts)
        want = bev.render_bev_image(*(t[0].cpu() for t in backproject_depth(d0.cpu(), c0.cpu(), zr)))
        if got.shape != (501, 501, 3) or not torch.equal(got.cpu(), want) or not bool(want.any()):
            raise AssertionError(f"phase 14: render_bev_image ({surface}) differs between the card and the CPU")
        out["launches"][f"render_bev_image_{surface}"] = counts
        log(f"phase 14: render_bev_image, {surface}, 512x1024 -> 501^2: card equals CPU bit for bit "
            f"({float((want > 0).float().mean()):.3f} of the texels nonzero); launches {counts}")
        if surface == "floor":
            cell, key, ok = splat_keys_at(bev, splat, xyz, col, val, 500, 0.02)
            lib_idx, lib_src = library_splat_inputs(cell, key, ok, 501 * 501)
            out["kernels"]["splat"] = {
                "shape": f"1x{cell.shape[1]} points -> 1x501^2 grid (render_bev_image)",
                "ms": time_ms(lambda: splat.splat_priority_grid(cell, key, ok, 501, 501)),
                "plain_ms": time_ms(lambda: splat.splat_priority_grid_plain(cell, key, ok, 501, 501)),
                "library_ms": time_ms(lambda: library_splat(lib_idx, lib_src, 1, 501 * 501, dev)),
                "bound_ms": (cell.shape[1] * 9 + 501 * 501 * 4) / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes",
            }
            args = fill_inputs(bev, splat, xyz, col, val, 500, 0.02)
            if not torch.equal(fill.fill_and_mask(*args), fill.fill_and_mask_plain(*args)):
                raise AssertionError("phase 14: B2 disagrees with its plain version at 1x501^2")
            out["kernels"]["fill"] = dict(fill_row(fill, args), shape="1x501^2x3 (render_bev_image)")
    for name, row in out["kernels"].items():
        row["card"] = card
        log(f"phase 14: {card}: {name} at {row['shape']}: {row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, library "
            f"{row['library_ms']}), bound {row['bound_ms']:.4f} ms by {row['bound_by']}")

    # (b) render_bev_pair for one hypothesis, render_bev_pairs_batch for 16 pairs.
    cfg = bev_pair.BEVRenderConfig()
    hyps = make_hypotheses(SINGLE_BATCH_PAIRS, seed=14, n_panos=len(depths_np))
    pairs = np.array([[i1, i2] for i1, i2, _ in hyps])
    R = np.stack([h.i2Ti1.rotation for _, _, h in hyps])
    t = np.stack([h.i2Ti1.translation for _, _, h in hyps])
    bank_d = torch.as_tensor(depths_np.astype(np.float32), device=dev)
    bank_c = torch.as_tensor(rgbs_np, device=dev)
    for surface in ("floor", "ceiling"):
        i1, i2, h = hyps[0]
        pair_args = (depths_np[i1], rgbs_np[i1], depths_np[i2], rgbs_np[i2], h.i2Ti1, surface, cfg)
        one, counts = launched(lambda: bev_pair.render_bev_pair(*pair_args, device=dev))
        expect_one_each(f"render_bev_pair ({surface})", counts)
        out["launches"][f"render_bev_pair_{surface}"] = counts
        batch, counts = launched(lambda: bev_pair.render_bev_pairs_batch(depths_np, rgbs_np, pairs, R, t, surface,
                                                                         cfg, device=dev))
        expect_one_each(f"render_bev_pairs_batch ({surface})", counts)
        out["launches"][f"render_bev_pairs_batch_{surface}"] = counts
        rows = [x.cpu().numpy() for x in bev_pair.render_bev_pairs_batch_device(bank_d, bank_c, pairs, R, t, surface,
                                                                                 cfg)]
        cpu_batch = bev_pair.render_bev_pairs_batch(depths_np, rgbs_np, pairs, R, t, surface, cfg, device=cpu)
        # The single pair is the batch's first: equal to its rows, so to the CPU's.
        for k in range(2):
            if not (np.array_equal(batch[k], rows[k]) and np.array_equal(batch[k], cpu_batch[k])
                    and np.array_equal(one[k], batch[k][0])):
                raise AssertionError(f"phase 14: the pair renders ({surface}, image {k + 1}) differ")
        log(f"phase 14: render_bev_pair and render_bev_pairs_batch ({SINGLE_BATCH_PAIRS} pairs), {surface}: equal to "
            f"render_bev_pairs_batch_device's rows and to the CPU bit for bit; one B1 and one B2 a call")

    # (c) the layout pair raster on two panos of phase 6's floor 0000.
    gt = get_gt_pose_graph("0000", "floor_01", str(root / "zind"))
    ids = sorted(gt.nodes)
    S = Sim2.from_theta_deg(33.0, np.array([0.4, -0.3]))
    got, counts = launched(lambda: layout.rasterize_room_layout_pair(S, gt.nodes[ids[0]], gt.nodes[ids[1]], device=dev))
    want = layout.rasterize_room_layout_pair(S, gt.nodes[ids[0]], gt.nodes[ids[1]], device=cpu)
    if not all(np.array_equal(a, b) for a, b in zip(got, want)) or counts != {"splat": 0, "fill": 0, "warp": 0,
                                                                               "layout": 2}:
        raise AssertionError(f"phase 14: rasterize_room_layout_pair differs between the card and the CPU ({counts})")
    log(f"phase 14: rasterize_room_layout_pair, panos {ids[0]} and {ids[1]} of floor 0000: card equals CPU bit for "
        f"bit; launches {counts}")

    # (d) the depth-map CLI on one of phase 8's panos and its depth PNG.
    pano = sorted((root / "zind" / "0000" / "panos").glob("*.jpg"))[0]
    depth = root / "depth" / "0000" / f"{pano.stem}.depth.png"
    images, counts = launched(lambda: depthmap_cli.backprojected_bev_images(str(depth), str(pano), device=dev))
    if counts != {"splat": 2, "fill": 2, "warp": 0, "layout": 0}:
        raise AssertionError(f"phase 14: the depth-map CLI's images launched {counts}")
    out["launches"]["depthmap_cli"] = counts
    cpu_images = depthmap_cli.backprojected_bev_images(str(depth), str(pano), device=cpu)
    if [t for t, _ in images] != ["floor", "ceiling"] or not all(
            np.array_equal(a, b) for (_, a), (_, b) in zip(images, cpu_images)):
        raise AssertionError("phase 14: the depth-map CLI's images differ between the card and the CPU")
    png_path = root / "single" / "backprojected_bev.png"
    argv = ["--depth_fpath", str(depth), "--rgb_fpath", str(pano), "--save_fpath", str(png_path), "--device", dev.type]
    png_path.parent.mkdir(parents=True, exist_ok=True)
    if have["matplotlib"]:
        with contextlib.redirect_stdout(io.StringIO()):
            depthmap_cli.main(argv)
        decoded = plotting.pyplot("phase 14").imread(str(png_path))
        if decoded.ndim != 3 or decoded.shape[0] < 100:
            raise AssertionError(f"phase 14: the depth-map CLI's PNG decodes to {decoded.shape}")
        cli_note = f"wrote a PNG that decodes to {decoded.shape}"
    else:
        try:
            depthmap_cli.main(argv)
        except plotting.MatplotlibMissing as e:
            cli_note = f"raised MatplotlibMissing ({e})"
        else:
            raise AssertionError("phase 14: the depth-map CLI ran without matplotlib")
        if png_path.exists():
            raise AssertionError("phase 14: the depth-map CLI wrote a file without matplotlib")
    log(f"phase 14: visualize_backprojected_depthmap on {pano.name}: the images on the card equal the CPU's, "
        f"launches {counts}; the CLI {cli_note}")

    # (e) run_sfm on floor 0000 with plot_save_dir, against phase 6's card run.
    handler = _Records()
    logging.getLogger(plotting.__name__).addHandler(handler)
    plotting._warned.clear()  # phase 6 may have named the report's figures already
    plot_dir = root / "out" / "single_0000"
    try:
        reports = run_incremental_reconstruction(
            hypotheses_save_root=str(root / "hyp"), serialized_preds_json_dir=str(root / "preds" / "0000"),
            raw_dataset_dir=str(root / "zind"), method="pose2_slam", confidence_threshold=STAGE_D_THRESHOLD,
            allowed_wdo_types=STAGE_D_WDO_TYPES, use_axis_alignment=False, predictions_data_root=None,
            plot_save_dir=str(plot_dir), rescue_clusters=True, device=dev)
    finally:
        logging.getLogger(plotting.__name__).removeHandler(handler)
    # Phase 6's card run of the same floor, call and configuration.
    before = root / "out" / f"frozen_card_0000_{dev.type}"
    row = next(x for x in stage_d["floors"] if x["floor"] == "0000")
    r = reports[0]
    gaps = [abs(r.avg_abs_rot_err - row["rot_err_deg"]), abs(r.avg_abs_trans_err - row["trans_err_m"])]
    if (len(reports) != 1 or (r.percent_panos_localized, r.percent_in_top2_ccs, r.percent_in_top3_ccs, r.floorplan_iou)
            != (row["localized_pct"], row["top2_pct"], row["top3_pct"], row["iou"]) or max(gaps) > 1e-6):
        raise AssertionError(f"phase 14: run_sfm's report {r} is not phase 6's {row}")
    name = "0000__floor_01.json"
    a, b = (json.loads((Path(f"{d}_serialized") / name).read_text())["wSi_dict"] for d in (plot_dir, before))
    pose_gap = max(float(np.max(np.abs(np.subtract(a[i][k], b[i][k])))) for i in b for k in ("R", "t", "s"))
    summary_now, summary_before = (json.loads((d / "summary.json").read_text()) for d in (plot_dir, before))
    if a.keys() != b.keys() or pose_gap > 1e-9 or summary_now.keys() != summary_before.keys() or any(
            abs(summary_now[k] - summary_before[k]) > 1e-6 for k in summary_now):
        raise AssertionError(f"phase 14: run_sfm's poses ({pose_gap}) or summary {summary_now} are not phase 6's "
                             f"{summary_before}")
    figures = sorted(str(p.relative_to(root / "out")) for p in (root / "out").glob("single_0000*/*.jpg"))
    warned = [r.getMessage() for r in handler.records]
    if have["matplotlib"]:
        ok = figures == ["single_0000/0000_floor_01.jpg", "single_0000__floorplan_iou/0000_floor_01.jpg"] and not warned
    else:
        ok = figures == [] and len(warned) == 1
    if not ok:
        raise AssertionError(f"phase 14: run_sfm with plot_save_dir wrote figures {figures}, warned {warned}")
    log(f"phase 14: run_sfm, floor 0000, plot_save_dir: report, serialized poses and summary.json those of phase "
        f"6's card run (errors within {max(gaps):.1e}, poses within {pose_gap:.1e}); figures {figures}; "
        f"warnings {warned}")

    # (f) visualize_floorplans_side_by_side_baselines on one seeded OpenSfM floor.
    results = root / "sfm_results_single"
    seeded_sfm.write_opensfm_reconstruction(str(results), str(root / "zind"), "0000", "floor_01", seed=0)
    base = ["--raw_dataset_dir", str(root / "zind"), "--results_dir", str(results), "--algorithm_name", "opensfm"]
    with contextlib.redirect_stdout(io.StringIO()):
        if have["matplotlib"]:
            card_reports = baselines_cli.main(base + ["--save_dir", str(root / "baselines_card"), "--device",
                                                      dev.type])
        else:
            try:
                baselines_cli.main(base + ["--save_dir", str(root / "baselines_refused"), "--device", dev.type])
            except plotting.MatplotlibMissing:
                pass
            else:
                raise AssertionError("phase 14: the baselines CLI ran without matplotlib")
            if (root / "baselines_refused").exists():
                raise AssertionError("phase 14: the baselines CLI wrote a file without matplotlib")
            card_reports = baselines_cli.baseline_floor_reports(str(root / "zind"), str(results), "opensfm",
                                                                str(root / "baselines_card"), device=dev)
        cpu_reports = baselines_cli.baseline_floor_reports(str(root / "zind"), str(results), "opensfm",
                                                           str(root / "baselines_cpu"), device=cpu)
    gap = compare_reports("phase 14: visualize_floorplans_side_by_side_baselines", card_reports, cpu_reports)
    r = card_reports[0]
    log(f"phase 14: visualize_floorplans_side_by_side_baselines, opensfm floor 0000 on the card: localized "
        f"{r.percent_panos_localized:.2f}%, IoU {r.floorplan_iou:.4f}; equal to the CPU's report (errors "
        f"{gap:.2e} apart)")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 14: {out['seconds']:.1f} s")
    return out


def horizon_phase(dev, root: Path) -> dict:
    """Phase 16 (module docstring): HorizonNet computing a layout verifier's
    rooms inside the scorer, through `test_fused --horizonnet_ckpt`."""
    import numpy as np
    import torch

    from salve_tpu_torch.cli import test_fused
    from salve_tpu_torch.dataset import procedural
    from salve_tpu_torch.dataset.hnet_prediction_loader import load_hnet_predictions
    from salve_tpu_torch.dataset.seeded_predictions import pano_image_paths, write_seeded_mhnet_predictions
    from salve_tpu_torch.geometry.sim2 import Sim2
    from salve_tpu_torch.models.early_fusion import EarlyFusionCEResnet
    from salve_tpu_torch.models.horizonnet import HorizonNet, load_horizonnet
    from salve_tpu_torch.native import jpeg, png
    from salve_tpu_torch.pipeline import fused_inference
    from salve_tpu_torch.rendering import bev_pair
    from salve_tpu_torch.utils import profiler

    t_phase = time.perf_counter()
    bid = "0996"
    building = procedural.generate_building_json(HORIZON_SEED, n_rows=1, n_cols=2)
    raw, depth, mhnet, hyp = (root / "horizon" / d for d in ("raw", "depth", "mhnet", "hyp"))
    (raw / bid).mkdir(parents=True)
    (raw / bid / "zind_data.json").write_text(json.dumps(building))
    rng = np.random.default_rng(HORIZON_SEED)
    paths = pano_image_paths(building)
    for rel in paths.values():
        img = raw / bid / rel
        img.parent.mkdir(parents=True, exist_ok=True)
        jpeg.write_jpeg(img, rng.integers(0, 255, (512, 1024, 3)).astype(np.uint8))
        d = depth / bid / f"{Path(rel).stem}.depth.png"
        d.parent.mkdir(parents=True, exist_ok=True)
        d.write_bytes(png.encode_png(rng.integers(1000, 4000, (512, 1024)).astype(np.uint16)))
    write_seeded_mhnet_predictions(mhnet, bid, building, HORIZON_SEED)
    ids = sorted(paths)
    for k, (i1, i2) in enumerate((a, b) for a in ids for b in ids if a < b):
        for label in ("gt_alignment_approx", "incorrect_alignment"):
            (hyp / bid / "floor_01" / label).mkdir(parents=True, exist_ok=True)
            Sim2.from_theta_deg(float(rng.uniform(-180, 180)), rng.uniform(-1, 1, 2)).save_as_json(
                str(hyp / bid / "floor_01" / label / f"{i1}_{i2}__door_{k}_0_identity.json"))
    modalities = ("ceiling_rgb_texture", "floor_rgb_texture", "layout")
    torch.manual_seed(HORIZON_SEED)
    torch.save(EarlyFusionCEResnet(num_layers=152, modalities=modalities, compute_dtype="bfloat16").state_dict(),
               root / "horizon" / "six_images.pt")
    ckpt = root / "horizon" / "resnet50_rnn_seeded.pth"
    torch.save({"kwargs": {"backbone": "resnet50", "use_rnn": True}, "state_dict": HorizonNet().state_dict()}, ckpt)

    names = ("horizon/panos", "horizon/graph_replays", "horizon/graph_captures", "horizon/eager", "boundary/vertices")
    before = {n: profiler.counter(n) for n in names}
    argv = ["--hypotheses_save_root", str(hyp), "--raw_dataset_dir", str(raw), "--depth_save_root", str(depth),
            "--ckpt_fpath", str(root / "horizon" / "six_images.pt"), "--building_id", bid,
            "--serialization_save_dir", str(root / "horizon" / "preds"), "--modalities", *modalities,
            "--mhnet_predictions_data_root", str(mhnet), "--horizonnet_ckpt", str(ckpt), "--device", "cuda"]
    t0 = time.perf_counter()
    test_fused.main(argv)
    cli_s = time.perf_counter() - t0
    counts = {n: profiler.counter(n) - before[n] for n in names}
    probs = [p for f in sorted((root / "horizon" / "preds").glob("batch_*.json"))
             for p in json.loads(f.read_text())["y_hat_probs"]]
    n_hyps = 2 * len(ids) * (len(ids) - 1) // 2
    if len(probs) != n_hyps or not all(0.0 <= p <= 1.0 for p in probs):
        raise AssertionError(f"phase 16: {len(probs)} answers for {n_hyps} hypotheses: {probs[:4]}")

    # The floor's boundaries on the card (as the CLI computed them) and the CPU.
    rgbs = torch.as_tensor(np.stack([bev_pair.load_pano_rgb(str(raw / bid / paths[i])) for i in ids]),
                           dtype=torch.float32)
    card_model = fused_inference.place(load_horizonnet(str(ckpt), device=dev), dev)
    x = rgbs.to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = fused_inference.floor_boundary_bank(card_model, x)
    torch.cuda.synchronize()
    boundary_ms = (time.perf_counter() - t0) * 1e3
    cpu = fused_inference.floor_boundary_bank(load_horizonnet(str(ckpt), device="cpu"), rgbs)
    gap = float((card.cpu() - cpu).abs().max())
    preds = load_hnet_predictions(bid, str(raw), str(mhnet))["floor_01"]
    spans = [{t: [(w.s, w.e) for w in getattr(preds[i], t)] for t in ("doors", "windows", "openings")} for i in ids]
    vertices = sum(len(room) for room, _ in fused_inference.boundary_layouts(card.cpu().numpy(), spans))
    chunks = -(-len(ids) // fused_inference.HORIZON_CHUNK)
    want = {"horizon/panos": len(ids), "horizon/graph_replays": chunks, "horizon/eager": 0,
            "boundary/vertices": vertices}
    if any(counts[n] != v for n, v in want.items()) or counts["horizon/graph_captures"] > chunks:
        raise AssertionError(f"phase 16: counters {counts}, expected {want} and at most {chunks} captures")
    if not gap <= HORIZON_ROWS_BOUND:
        raise AssertionError(f"phase 16: the card's boundaries are {gap} rows from the CPU's")
    log(f"phase 16: test_fused --horizonnet_ckpt on building {bid} (floor_01, {len(ids)} panos, {n_hyps} "
        f"hypotheses): {cli_s:.2f} s, counters {counts}; boundaries {boundary_ms:.1f} ms on the card, "
        f"{gap:.3e} rows from the CPU's (bound {HORIZON_ROWS_BOUND}), rows {float(cpu.min()):.1f}-"
        f"{float(cpu.max()):.1f}")
    return {"seconds": time.perf_counter() - t_phase, "cli_s": cli_s, "panos": len(ids), "hypotheses": n_hyps,
            "counts": counts, "boundary_ms": boundary_ms, "cpu_gap_rows": gap}


def main() -> int:
    # Deterministic cuBLAS products (the training policy) need this before
    # the process's first cuBLAS call.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    sd = report["stage_d"]
    log(f"throughput: Stage D frozen configuration {sd['ms_card_median']:.1f} ms a floor on the card, "
        f"{sd['ms_cpu_median']:.1f} ms on the CPU (run_incremental_reconstruction, median of "
        f"{len(sd['floors'])} floors)")
    st = report["stitching"]
    log(f"throughput: stitching {st['layouts_ms_card_median']:.1f} ms a floor on the card, "
        f"{st['layouts_ms_cpu_median']:.1f} ms on the CPU (stitch_building_layouts); stitch_clusters "
        f"{st['clusters_ms_card_median']:.1f} / {st['clusters_ms_cpu_median']:.1f} ms (median of {STAGE_D_FLOORS} floors)")
    cp = report["corpus"]
    for arm in ("warp", "direct"):
        rows_card, rows_cpu = cp[f"{arm}_card"]["rows"], cp[f"{arm}_cpu"]["rows"]
        log(f"throughput: corpus {arm} arm " + "; ".join(
            f"floor {a['floor']} {a['pairs_per_s']:.2f} pairs/s on the card ({a['ms']:.1f} ms), {b['pairs_per_s']:.2f} "
            f"on the CPU ({b['ms']:.1f} ms)" for a, b in zip(rows_card, rows_cpu)))
    tr = report["training"]["times"]
    log(f"throughput: training {tr['train_tuples_per_s']:.1f} tuples/s a train step at batch 256 under the "
        f"deterministic policy ({tr['train_step_ms']:.2f} ms; {tr['train_tuples_per_s_without_policy']:.1f} without "
        f"it), eval {tr['eval_tuples_per_s']:.1f} tuples/s, "
        f"{100 * tr['bf16_peak_share']:.2f}% of the bf16 peak")
    dp = report["depth"]
    log(f"throughput: depth, HoHoNet batch_hohonet_inference {dp['hohonet']['panos_per_s']:.2f} panos/s "
        f"(forward {dp['hohonet']['forward_ms']:.3f} ms); PanoDepthNet train step "
        f"{dp['depth_net']['images_per_s']:.1f} images/s at batch {DEPTH_TRAIN_BATCH} "
        f"({dp['depth_net']['train_step_ms']:.2f} ms)")
    e2 = report["e2e"]
    v = e2["harness"]["summary"]["verifier"]
    log(f"throughput: end-to-end run {e2['harness']['seconds']:.1f} s over {e2['harness']['floors']} floors "
        f"(verifier mAcc {v['mAcc']:.4f} on the held-out building); the materializer "
        + ", ".join(f"{bid} {x:.3f}" for bid, x in e2["harness"]["materialize_s_per_pano"].items())
        + f" s a pano; the provider branch {e2['provider']['s_per_pano']:.3f} s a pano")
    ev = report["evaluation"]
    log(f"throughput: eval_floorplan {ev['eval_floorplan']['ms_card']:.1f} ms a floor on the card, "
        f"{ev['eval_floorplan']['ms_cpu']:.1f} ms on the CPU; evaluate_sfm_baseline " + "; ".join(
            f"{alg} {row['ms_card']:.1f} / {row['ms_cpu']:.1f} ms" for alg, row in ev["sfm"].items())
        + " a floor, card / CPU")
    ms = report["mesh"]
    log(f"throughput: phase 13, a world of two on one card: {ms['b']['seconds']:.1f} s for both ranks' scoring and "
        f"{MESH_TRAIN_STEPS} train steps (per rank " + ", ".join(f"{r['train_s']:.3f}" for r in ms["b"]["ranks"])
        + f" s of steps); the phase {ms['seconds']:.1f} s")
    sg = report["single"]
    log(f"throughput: phase 14, B1 {sg['kernels']['splat']['ms']:.4f} ms and B2 {sg['kernels']['fill']['ms']:.4f} ms "
        f"at B = 1 (501^2; bounds {sg['kernels']['splat']['bound_ms']:.4f} and {sg['kernels']['fill']['bound_ms']:.4f} "
        f"ms); the phase {sg['seconds']:.1f} s")
    ch = report["chain"]
    log(f"throughput: phase 15, the inference chain on floor {CHAIN_FLOOR} through the CLIs: "
        f"{sum(ch['seconds_card'].values()):.1f} s on the card (" + ", ".join(
            f"{k} {v:.2f}" for k, v in ch["seconds_card"].items()) + f"); the phase {ch['seconds']:.1f} s")
    hz = report["horizon"]
    log(f"throughput: phase 16, test_fused --horizonnet_ckpt scored {hz['hypotheses']} hypotheses of a "
        f"{hz['panos']}-pano floor in {hz['cli_s']:.2f} s (boundaries {hz['boundary_ms']:.1f} ms on the card); "
        f"the phase {hz['seconds']:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "l2_bound_ms", "dsmem_bound_ms", "params_ms", "launches_direct",
            "launches_corpus", "launches_depth", "launches_e2e", "launches_mesh", "launches_single",
            "launches_chain", "shape", "extra")
    rows = [{kk: row.get(kk) for kk in keys} for row in report["kernels"].values()]
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
