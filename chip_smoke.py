"""Smoke run of the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Drives Detector.read -> BatchedMatcher(prune_mode="pooled") -> Matches
(and every other ported path: phases 6-13) on the committed RGB-D bank at
full width (480x640 frames, 16 response
channels, Fmax 128), after building the hand-written CUDA kernels K1
(ColorGradient quantizer), K2 (spread + response), K3 (local walk) and
DN (DepthNormal quantizer and its median) from csrc/.  Phases, one JSON
line each:

  0. card label (nvidia-smi) and the kernel build;
  1. K1 and K2 against their plain PyTorch versions on the card, bitwise,
     at the main path's shapes (B=32 at 480x640 and 240x320), with CUDA
     event times of both and each launch's bound (ops/roofline.py); then
     on odd shapes (widths off the kernels' tiles and off 4, 1- and 7-row
     frames, 1x1 and 3x3 frames; K1 on u8 and f32, K2 at T=5 and 8 into a
     channel slice of a wider stack whose other channels keep their
     bytes); DN against the plain DepthNormal on the batch's depths
     (B=32 at 480x640), timed with its bound, then on
     utils/kernel_cases.py's depth_normal_cases;
  2a. the untiled 2652-template bank on the 8-frame golden batch: Matches,
      n_valid, PooledStats and R0/R1 hashes equal the JAX reference's
      (tests/data/torch_port_golden.npz);
  2b. B=32 over the bank tiled to 10,624 templates: the kernel path equals
      the plain path (every Matches field); launch counts of K1/K2/K3 in
      that run (DN and XS exactly once, BM three times; none in the plain run), the
      matcher's exact weights without a dense one-hot operand,
      PooledStats, found rate, batch time;
  2c. the same batch with pool_coarse forced tiny: the exhaustive fallback
      runs (XS and TK once each, BM for the group and cell tiers alone)
      and the Matches equal 2b's;
  2d. XS (the exact coarse scorer) against its plain twin and the int8
      GEMM route it replaced, bitwise, on 2b's level-1 responses and
      tiled bank: every cell of the batch (the fallback's call) and a
      frame-major 1152-row list (the exact tier's 36 rows a frame), timed
      beside its bound, the plain twin and that route (library_ms);
  2e. TK (the exhaustive select's top-k) against its plain twin, bitwise,
      at batch32-fullbin's shape (B=32 six-object frames, 1200 cells x
      10,624 templates, k 128) on XS's scores of them, timed beside its
      bound, the plain twin and the library call at its core (torch.topk
      over the batch's unique int64 keys, built beforehand: library_ms);
  2f. BM (the bound margins) against its plain twin, bitwise, on the
      operands of 2b's three launches (the group, cell and fine tiers,
      captured from one pooled batch), timed beside its bound, the plain
      twin (torch._int_mm and the (M, N) epilogue it replaced, which is
      also library_ms) and torch._int_mm alone (gemm_ms); the batch's
      peak device memory over the bound tiers' (M, N) int32; then on
      utils/kernel_cases.py's odd operand sets;
  3. K3 against its plain version on 2b's candidate sets, bitwise, timed
     with its bound; then on odd plans (utils/kernel_cases.py: frames
     with n_valid = 0, walked slots with every feature dead, F = 37 and
     300, placements past the frame's edges, B = 1, T = 4);
  4. K4 (triangle z-buffer) against its plain version, bitwise on depth,
     mask and shade, timed with its bound: the cuboid stand-in for the
     boxNew mesh (1984 padded triangles) at 4 bank poses in the 256x256
     render viewport (detect's 4 cluster lanes) and at 8, one full
     640x480 frame at the bank's intrinsics, and one off-screen pose
     (every z inf); then on odd cases (utils/kernel_cases.py: every row
     duplicated with another shade, so only the first index may win each
     exact depth tie; a tile that > 256 triangles reach; 250x170 and 1x1
     viewports);
  5. K2b: the single-frame preprocess_frame at 480x640, both modalities,
     its B=1 K1 and K2 launches against the plain path, bitwise;
  6. the cascade golden: DetectionPipeline.detect at full width (640x480,
     the 2652-template RGB-D bank and its params, the cuboid, default
     CascadeParams, threshold 91) on the frames of
     tests/data/torch_cascade_golden.npz: Matches equal to the JAX
     reference's, the ClusterSet's integer fields equal, per lane the
     valid flag and rect equal and the pose within POSE_TOL (0.01 degrees
     / 0.01 mm), a detection on each object frame and none on the
     background frame; launch counts of K1-K4, detect ms per frame;
     K3 and K4 on the operands one detect passes them (captured from the
     call), bitwise against plain and timed; then a control: the same
     frames with TF32 matmuls switched on must fall outside POSE_TOL (so
     the limit sees reduced precision);
  7. the K5 path: BatchedMatcher(prune=False) (the exhaustive mode) gives
     phase 2b's batch its 4096 candidates over the tiled bank, and
     refine_candidates_pallas_batched refines them through K5 (launch
     counts of that run, chain and exhaustive batch times); K5 against
     its plain version, bitwise, on those candidates (timed, with its
     bound; also at a 40 x 40 window and on a stack whose data pointer is
     odd), on a set whose windows reach past the frame's bottom-right
     edge, and on odd cases (utils/kernel_cases.py: windows of 1, 7, 24
     and 40, F = 37 and 300 with responses up to 255, nf of 0 and above
     F, W = 643, anchors on the bottom-right edge and reads above and
     left of the frame, a (C, H, W) input, an odd data pointer with the
     storage reaching past the tensor and ending with it); the chain's
     Matches against the plain chain's and, frame by
     frame, against refine_candidates, _slices and _conv; then on the
     cascade golden frames with the untiled bank at threshold 91 the
     exhaustive match_batch, the K5 chain and one make_matcher_fn frame
     against the JAX reference (tests/data/torch_window_golden.npz);
  8. the two-object path (the reference bench's configuration: the bank
     under two class ids at thresholds 92 / 94, pools 56 B / 36 B):
     MultiClassBatchedMatcher(prune_mode="pooled") on the cascade golden
     frames against the JAX reference (each class's Matches and the
     PooledStats), then B=32 (phase 2b's first 28 scenes and the 4
     cascade frames) over the bank tiled to 10,624 per class (21,248 in
     all): kernel path against plain path, the merged valid
     matches against two single-class pooled batches', launch counts,
     the merged batch time and the split time (the two single-class
     batches, as the reference bench times its alternator).

  9. the per-frame-cap prune modes: on the cascade golden frames with the
     untiled bank, BatchedMatcher(prune=True) in the `positions` mode (its
     defaults, a fine_pos_cap that the fine survivors overflow, a
     prune_pos_cap that the coarse survivors overflow), in the `two_axis`
     mode, and the default-mode MultiClassBatchedMatcher against the JAX
     reference (Matches, PrunePlan, FinePlan;
     tests/data/torch_prune_golden.npz); then B=32 (phase 8's batch: 28
     scenes and the 4 cascade frames) over the bank tiled to 10,624: the
     three `positions` settings, each kernel path against plain path
     (Matches and plans), its valid matches against the pooled matcher's
     on the same batch, the plans' rows of the golden frames against the
     golden, launch counts and batch times by CUDA events; `two_axis` at
     its defaults with its overflow flag; the default-mode two-object
     matcher against phase 8's pooled result per class; and the RGB-only
     bank (C = 8: K1 x2, K2 x2) tiled to 10,624 through the pooled path.

  10. the cascade's non-default options: DetectionPipeline.detect at full
      width in each configuration of models.cascade.GOLDEN_OPTION_SETS (the
      accuracy configuration — point-to-plane ICP, two orientation
      hypotheses, NMS after the pose: 8 pose slots x 2 hypotheses = 16
      lanes — on all four cascade frames; the same with one refinement
      round, LM ICP, and the roi_center, distance_offset and
      local_descriptor position strategies on frame 0) against the JAX
      reference (tests/data/torch_cascade_options_golden.npz): Matches,
      ClusterSet, keep mask, cluster order, per lane the valid flag and
      rect equal, each valid lane's pose within POSE_TOL (or the
      configuration's entry of OPTION_POSE_TOL); launch
      counts of K1-K4 in each configuration's run (counts set to 0 just
      before it), ICP iterations per lane, detect ms (median of 5) beside
      the default detect's; K4 on the operands the accuracy detect passes
      it (16 lanes; the refinement round's render with one intrinsic
      matrix per lane), bitwise against plain and timed with its bound;
      inplane_sweep_fix on the two real clouds
      (data/sweep_view{00,45}_clouds.npz): applied, within 0.5 degrees of
      3.02 and 1.35; and the TF32 control: the accuracy frames and the LM
      frame with TF32 matmuls on must fall outside their tolerances.

  11. serving (the surface between a camera and the robot's base frame):
      on the four cascade frames as replay frames (rgb + cloud, no depth
      image, so the match scores colour only: the RGB-only bank
      data/boxNew_full_*, the cuboid, default CascadeParams, threshold
      91), PoseService.linemod_object_pose against
      tests/data/torch_serving_golden.npz (the JAX reference's): the
      base-frame transforms within POSE_TOL, the identity on the
      background frame and on an unknown object id; the detections
      (rects equal, poses within POSE_TOL), StreamingDetector and
      PollingMultiObjectDetector on the same frames; look_at_point equal
      to the golden's; template_refinement from the golden's poses within
      POSE_TOL, and K4 on its operands (one pose in the 256 x 256
      viewport) bitwise against plain and timed with its bound; the CLI
      (`python -m linemod_pose_estimation_tpu_torch detect` and `serve`,
      subprocesses on the card) against the golden; launch counts of
      K1-K4 over the four requests and per request, request ms.  Then the
      streaming step of tools/bench_streaming_torch.py (B=32 pooled
      matcher over the RGB-D bank tiled to 10,624, the pose stage on the
      batch's best frame): its Matches against the plain matcher's, every
      field; PipelinedRunner(depth=2) against blocking calls over 8
      batches, in submission order; launch counts per step, blocking p50,
      pipelined p50 per submit, device ms per step, busy share.  Last the
      tool itself as subprocesses: a paced and a saturated run of 10 s and
      its --e2e probe, each record on its own line (reported, not gated).

  12. the offline trainer (the cuboid written as a binary STL, the
      reference's TrainerConfig(): 640x480, fx 535.566011, fy 537.168115,
      the launch-scale view sphere, render_batch 16): K4 against plain,
      bitwise, at one trainer chunk (the sphere's first 16 views), its
      rects equal to the reference's renders, timed with its bound; K1's
      magnitude variant against the plain quantizer, bitwise on both
      outputs, at the chunk's two shapes (16 x 480x640 u8, its pyrDown 16 x
      240x320 f32; timed with its bound) and on ODD_SHAPES; DN against the
      plain DepthNormal on the chunk's depths (16 x 480x640, timed with
      its bound); train_and_write
      in both modes (RGB-only, ColorGradient + DepthNormal) over the
      golden's 32 views against tests/data/torch_trainer_golden.npz (the
      templates YAML byte-identical, the params equal with D within
      D_TOL); trained view 0 re-rendered and matched: template 0 at >= 95;
      train_from_stl in RGB-D over TRAIN_VIEWS views: views/s, wall, the
      host's dispatch / wait / extract seconds, each chunk's device span,
      busy share, peak memory, launch counts (K4 x1, K1 x2 and DN x1 a
      chunk, and no plain version called); then `python -m
      linemod_pose_estimation_tpu_torch train` as a subprocess on the card
      over the golden's views, its JSON line and files against the golden.
  13. the off-main-path matchers and the aux modules: Detector(engine=
      "gather") and Detector(engine="auto") (the GEMM) over the 2652-
      template RGB-D bank on the four cascade golden frames, every Matches
      field equal to the golden's (which the reference's gather engine
      made), the launches of K1, K2b and K3 in one gather match; on each
      frame's level-1 responses coarse_scores, coarse_scores_conv (the
      bank's dense filters) and coarse_scores_gemm bitwise equal,
      select_candidates_approx equal to select_candidates and to a stable
      descending sort of the flat scores; CUDA-event ms of each coarse
      engine and of match_raw per engine, the dense filters' bytes; then
      grasping_pose_region_growing, mls_smooth, estimate_normals and
      euclidean_cluster_largest on the sweep views' scene clouds and a
      4096-point ROI of golden frame 0 (its cloud rebuilt on the card)
      against tests/data/torch_aux_golden.npz: masks equal, pose, smoothed
      points and normals within GRASP_TOL, points with fewer than three MLS
      neighbours counted, ms per call; then rgb_to_hsv_u8 (bitwise, by
      SHA-256), hsv_color_filter, absolute_rectangle and nms_distance on
      the golden frames, their detections and seeded inputs, equal.
  14. the multi-device layer (parallel/), in processes of its own
      (parallel.mesh.spawn): two NCCL ranks on the one GPU, which NCCL
      refuses ("Duplicate GPU detected"; what it says is printed); then 4
      gloo ranks on cuda:0: the data=2 x bank=2 detect step (pooled with
      the group tier, positions), the row-sharded matcher (2 stripes of
      frame 0) and the 4-rank ring step on the cascade frames over the
      2652-template bank, every Matches field and metric equal to
      tests/data/torch_sharded_golden.npz and kernel path equal to plain
      path, which launches no kernel; the B=32 pooled step over the tiled
      bank on phase 8's batch (16 frames and 5312 templates a rank):
      kernel path equal to plain
      path on every rank, the best match per frame and the valid sets
      (where neither side filled top_k) equal to the single-device
      BatchedMatcher's, the group pool run, K1/K2/K3 launches per rank,
      PooledStats, prune_fallback_shards, the bytes each collective moves,
      the step's ms per rank by CUDA events (four ranks sharing one card);
      then the same step on one NCCL rank (a 1x1 mesh) against the gloo
      run and the single-device matcher, and its ms beside the matcher's.

Then a kernels summary line (per kernel: launches on its path, the
summed time, plain time and bound of those launches at their shapes,
what bounds it, the share of the bound, and library_ms: for XS the int8
GEMM route it replaced, for TK torch.topk over prebuilt keys, for the
others null, as no single PyTorch call computes them; the other timed
shapes are rows of its `shapes`), the card
line, and last
{"ok": true, "device": {...}}.  Any failed check raises, and the script
exits non-zero without printing the last line.  It needs CUDA: without a
card it exits 2 before doing anything.

    python3 chip_smoke.py --only options
    python3 chip_smoke.py --only serving
    python3 chip_smoke.py --only trainer
    python3 chip_smoke.py --only aux
    python3 chip_smoke.py --only parallel
    python3 chip_smoke.py --only exact
    python3 chip_smoke.py --only select
    python3 chip_smoke.py --only bounds

build the kernels and run phase 10, 11, 12, 13, 14, 2d, 2e or 2f alone (a quick
check on a card); they print no summary and no last line.
"""

from __future__ import annotations

import collections
import hashlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
BANK = os.path.join(REPO, "data", "boxNew_rgbd_templates.yml.gz")
PARAMS = os.path.join(REPO, "data", "boxNew_rgbd_params.yml.gz")
GOLDEN = os.path.join(REPO, "tests", "data", "torch_port_golden.npz")
CASCADE_GOLDEN = os.path.join(REPO, "tests", "data", "torch_cascade_golden.npz")
WINDOW_GOLDEN = os.path.join(REPO, "tests", "data", "torch_window_golden.npz")
PRUNE_GOLDEN = os.path.join(REPO, "tests", "data", "torch_prune_golden.npz")
OPTIONS_GOLDEN = os.path.join(REPO, "tests", "data", "torch_cascade_options_golden.npz")
SWEEP_CLOUDS = {"sweep_view45_clouds": 3.02, "sweep_view00_clouds": 1.35}  # degrees
RGB_BANK = os.path.join(REPO, "data", "boxNew_full_templates.yml.gz")
RGB_PARAMS = os.path.join(REPO, "data", "boxNew_full_params.yml.gz")
SERVING_GOLDEN = os.path.join(REPO, "tests", "data", "torch_serving_golden.npz")
STREAM_TOOL = os.path.join(REPO, "tools", "bench_streaming_torch.py")
TRAINER_GOLDEN = os.path.join(REPO, "tests", "data", "torch_trainer_golden.npz")
AUX_GOLDEN = os.path.join(REPO, "tests", "data", "torch_aux_golden.npz")
SHARDED_GOLDEN = os.path.join(REPO, "tests", "data", "torch_sharded_golden.npz")
# Phase 14's spawned ranks: start-up, the bank shards, every run of a rank.
PARALLEL_TIMEOUT_S = 420.0
# Views of phase 12's timed RGB-D training: the committed banks' count.
TRAIN_VIEWS = 2652
# Metres between the trainer's D and the reference's: D reads the render's
# centre depth, which the JAX CPU render puts up to 1e-3 mm off the plain
# rasterizer's (XLA's FMAs); K4 equals the plain rasterizer bitwise.
D_TOL = 1e-6
# K1 and K2's shapes off their tiles: widths that are not a multiple of
# K1's 92 output columns nor of K2's 4 pixels, 1- and 7-row frames, 1x1
# and 3x3 frames.
ODD_SHAPES = ((1, 7), (7, 13), (3, 3), (1, 1), (37, 131), (65, 249), (480, 643))
# Degrees, mm between the card's poses and the reference's.  The card in
# full f32 lands within 4e-5 deg / 1e-4 mm ("NVIDIA H100 80GB HBM3,
# 700.00 W"); the TF32 control below must land outside.  The CPU tests'
# looser 0.25 / 0.5 covers XLA's FMA contraction on the host, not the card.
POSE_TOL = (0.01, 0.01)
# The non-default cascade options against their golden (phase 10): the
# same limit, except where a configuration is named here; PERF.md section 6
# has what the card measured per configuration.
# LM ICP accepts a step on `new_cost < cost`, which flips on an ulp of the
# cost; lambda then takes another path and the passes end elsewhere on the
# plateau of its 1e-8 epsilon: the card and the CPU port both land 0.027
# degrees / 0.035 mm from the golden ("NVIDIA H100 80GB HBM3, 700.00 W").
OPTION_POSE_TOL = {"nonlinear": (0.05, 0.05)}
# Phase 13 against tests/data/torch_aux_golden.npz (tools/make_torch_aux_
# golden.py writes it; its inputs are rebuilt here the same way).  Grasp
# tolerances: degrees, mm, metres of the smoothed points, and the normals
# of the reference's smoothed points; the CPU port measures 2.7e-4 deg,
# 1.9e-4 mm, 2.4e-7 m and 6e-7 there (tests/test_torch_segmentation.py).
GRASP_TOL = (1e-3, 1e-3, 1e-6, 1e-5)
FX, FY = 535.566011, 537.168115
AUX_EUCLID_TOL = 0.005
AUX_GATE_RANGES = (((0.0, 180.0), (0.0, 255.0), (0.0, 255.0)),
                   ((0.0, 30.0), (50.0, 255.0), (50.0, 255.0)),
                   ((90.0, 150.0), (0.0, 255.0), (0.0, 255.0)),
                   ((0.0, 180.0), (0.0, 20.0), (0.0, 222.0)))
AUX_NMS_SIZES = (1, 3)
THRESHOLD = 91.0
B_MAIN = 32
TILE_TO = 10624  # the bank tiled up to >= 10,240 templates, padded to 128
KERNELS = {
    "quantize_cg": ("K1", "linemod_pose_estimation_tpu_torch/csrc/quantize_cg.cu",
                    "linemod_pose_estimation_tpu/ops/pallas_preprocess.py:195"),
    "spread_response": ("K2", "linemod_pose_estimation_tpu_torch/csrc/spread_response.cu",
                        "linemod_pose_estimation_tpu/ops/pallas_kernels.py:136"),
    "walk_scores": ("K3", "linemod_pose_estimation_tpu_torch/csrc/walk_scores.cu",
                    "linemod_pose_estimation_tpu/ops/pallas_kernels.py:403"),
    "spread_response_b1": ("K2b", "linemod_pose_estimation_tpu_torch/csrc/spread_response.cu",
                           "linemod_pose_estimation_tpu/ops/pallas_kernels.py:103"),
    "raster_zbuffer": ("K4", "linemod_pose_estimation_tpu_torch/csrc/raster_zbuffer.cu",
                       "linemod_pose_estimation_tpu/ops/pallas_raster.py:132"),
    "refine_scores": ("K5", "linemod_pose_estimation_tpu_torch/csrc/refine_scores.cu",
                      "linemod_pose_estimation_tpu/ops/pallas_kernels.py:228"),
    "depth_normal": ("DN", "linemod_pose_estimation_tpu_torch/csrc/depth_normal.cu",
                     "none (the reference's DepthNormal is XLA: "
                     "linemod_pose_estimation_tpu/ops/features.py:404)"),
    "exact_scores": ("XS", "linemod_pose_estimation_tpu_torch/csrc/exact_scores.cu",
                     "none (the reference's exact coarse scores are an XLA dot_general "
                     "over one-hot weights: linemod_pose_estimation_tpu/ops/match.py:274)"),
    "select_topk": ("TK", "linemod_pose_estimation_tpu_torch/csrc/select_topk.cu",
                    "none (the reference selects with jax.lax.top_k: "
                    "linemod_pose_estimation_tpu/ops/match.py:2006)"),
    "bound_margins": ("BM", "linemod_pose_estimation_tpu_torch/csrc/bound_margins.cu",
                      "none (the reference's bounds are an XLA dot_general and a margin "
                      "max: linemod_pose_estimation_tpu/ops/match.py:609)"),
}
# library_ms of the kernels that have one: what that call is
LIBRARY_NOTES = {
    "exact_scores": "the int8 GEMM route it replaced: the patch rows, torch._int_mm",
    "select_topk": "torch.topk over the batch's (B, P*N) unique int64 keys, built beforehand",
    "bound_margins": "torch._int_mm and the (M, N) int32 epilogue it replaced (the plain twin)",
}
# XS's rows in phase 2d: a frame-major list of 36 rows a frame (the exact
# tier's fine pool at B=32), drawn from this seed.
EXACT_POOL_ROWS, EXACT_POOL_SEED = 1152, 21
# TK's frames in phase 2e: six planted views each, drawn from this seed.
SELECT_SEED = 7


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` back-to-back calls (CUDA events,
    after one warm-up call)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def trace_kernel(fn, kernel: str, reps: int) -> tuple[dict, dict]:
    """One torch.profiler trace of `reps` calls of fn(): ({kernel name:
    summed device ms}, {kernel name: launches in the trace}) over the device
    kernels whose name holds `kernel`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    parts, counts = {}, {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if e.device_type == DeviceType.CUDA and kernel in e.key and us > 0:
            short = re.search(r"\w*%s\w*" % re.escape(kernel), e.key).group(0)
            parts[short] = parts.get(short, 0.0) + us / 1e3
            counts[short] = counts.get(short, 0) + e.count
    return parts, counts


def kernel_times(fn, kernel: str, reps: int = 20, per_call: int = 1) -> dict:
    """The time of one call of fn()'s kernel, two ways, after a warm-up:
    `ms`, the kernel's own device time (torch.profiler's CUDA time of the
    kernels whose name holds `kernel`, over `reps` calls), with `parts` per
    kernel name where a call launches several, and `call_ms`, the
    CUDA-event time per call of `reps` calls back to back, which for a
    kernel shorter than the wrapper's host work is the host's launch rate.
    A full trace holds `reps * per_call` launches (`per_call`: the kernels
    one call launches), but a trace can lose records (one card lost one of
    20 in three traces running), and the summed time over `reps` would then
    read short.  So the launches the trace holds are counted: a trace with
    another count is taken again, up to five times, the fullest one is
    kept, and each kernel's time is its summed time over the launches the
    trace holds of it, times the launches one call makes of it.  That mean
    is right whether or not records were lost.  A trace with no launch of
    the kernel, or with more than the calls made, fails.  `trace_launches`,
    `traces` and `trace_full` say what was read."""
    call_ms = cuda_ms(fn, reps)
    full = reps * per_call
    best = ({}, {})
    for traces in range(1, 6):
        parts, counts = trace_kernel(fn, kernel, reps)
        if sum(counts.values()) >= sum(best[1].values()):
            best = (parts, counts)
        if sum(counts.values()) >= full:
            break
    parts, counts = best
    launches = sum(counts.values())
    require(0 < launches <= full,
            f"{kernel}: the trace holds {launches} launches, {reps} calls of "
            f"{per_call} made {full}")
    per = {k: parts[k] / counts[k] * max(1, round(counts[k] / reps)) for k in parts}
    out = dict(ms=sum(per.values()), call_ms=call_ms, trace_launches=launches,
               traces=traces, trace_full=launches == full)
    if len(per) > 1:
        out["parts"] = per
    return out


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def matches_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def valid_equal(a, b) -> bool:
    """Same valid mask, and every field equal on the valid slots."""
    v = a.valid
    return torch.equal(v, b.valid) and all(torch.equal(x[v], y[v]) for x, y in zip(a, b))


def pose_err(a, b) -> tuple[float, float]:
    """(degrees, mm) between two (4, 4) poses."""
    from linemod_pose_estimation_tpu_torch.utils.geometry import rotation_geodesic_deg

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    deg = float(rotation_geodesic_deg(torch.tensor(a[:3, :3]), torch.tensor(b[:3, :3])))
    return deg, 1000.0 * float(np.linalg.norm(a[:3, 3] - b[:3, 3]))


def raster_vs_plain(coefs, w: int, h: int, name: str) -> dict:
    """K4 against its plain version, bitwise on depth, mask and shade."""
    from linemod_pose_estimation_tpu_torch.ops import raster as RA

    (zk, sk), (zp, sp) = RA.raster_zbuffer(coefs, w, h), RA.raster_zbuffer_plain(coefs, w, h)
    hit = torch.isfinite(zp)
    require(torch.equal(torch.isfinite(zk), hit), f"K4 {name}: mask differs from plain")
    require(torch.equal(zk, zp) and torch.equal(sk, sp),
            f"K4 {name}: depth or shade differs from plain")
    err = float(torch.where(hit, (zk - zp).abs() + (sk - sp).abs(), 0.0).max())
    return dict(max_abs_err=err, covered=int(hit.sum()), poses=int(coefs.shape[0]),
                triangles=int(coefs.shape[1]), viewport=[w, h])


def depth_normal_vs_plain(depth, dist: float, diff: float, name: str) -> dict:
    """DN against the plain DepthNormal on `depth`, bitwise, both timed,
    with the launch's bound."""
    from linemod_pose_estimation_tpu_torch.ops import cuda_preprocess as CP
    from linemod_pose_estimation_tpu_torch.ops import roofline as RL

    got = CP.quantize_depth_normal(depth, dist, diff)
    err = max_abs_err(got, CP.quantize_depth_normal_plain(depth, dist, diff))
    require(err == 0, f"DN {name} differs from its plain version")
    return dict(
        **kernel_times(lambda: CP.quantize_depth_normal(depth, dist, diff),
                       "depth_normal_kernel"),
        plain_ms=cuda_ms(lambda: CP.quantize_depth_normal_plain(depth, dist, diff), 3),
        max_abs_err=err, set_frac=float((got > 0).float().mean()),
        bound=RL.depth_normal(*depth.shape)._asdict())


def exact_scores_vs_plain(R1, table, dense, T: int, Kc: int, frame=None, pos=None) -> dict:
    """XS over the feature table against its plain twin and the int8 GEMM
    route it replaced (the im2col or the survivor gather, then
    torch._int_mm over the dense one-hot operand: library_ms), bitwise, on
    every cell of R1 (frame and pos None) or on the rows (frame, pos); all
    three timed, with the launch's bound."""
    from linemod_pose_estimation_tpu_torch.ops import cuda_kernels as CK
    from linemod_pose_estimation_tpu_torch.ops import match as M
    from linemod_pose_estimation_tpu_torch.ops import roofline as RL

    if frame is None:
        route = lambda: M.int8_mm(M._gemm_patches(R1, T, Kc), dense)
    else:
        route = lambda: M.int8_mm(M._survivor_patches(R1, frame, pos, T, Kc), dense)
    kern = lambda: CK.exact_scores(R1, table, T, Kc, frame, pos)
    plain = lambda: CK.exact_scores_plain(R1, table, T, Kc, frame, pos)
    got = kern()
    err = max_abs_err(got, plain())
    require(err == 0, f"XS differs from its plain twin on {got.shape[0]} rows")
    require(torch.equal(got, route()), f"XS differs from the int8 GEMM on {got.shape[0]} rows")
    B, C, H, Wd = R1.shape
    rows, (N, F) = got.shape[0], table.shape
    crop = B * C * (H // T * T) * (Wd // T * T)
    planes = crop if frame is None else min(crop, rows * Kc * Kc * C * T * T)
    del got
    return dict(**kernel_times(kern, "exact_", reps=5 if frame is None else 20),
                plain_ms=cuda_ms(plain, 1), library_ms=cuda_ms(route, 3), max_abs_err=err,
                rows=rows, templates=N,
                bound=RL.exact_scores(rows, N, F, int((table >= 0).sum()), planes)._asdict())


def exact_phase(dev: torch.device, perf: dict, matcher=None, rgbs=None, deps=None) -> None:
    """Phase 2d: XS on the tiled batch's level-1 responses and bank (built
    here when phase 2b's matcher and frames are not given), against the
    int8 GEMM over the bank's dense one-hot operand, built here for the
    comparison alone (the matcher holds none on the card)."""
    from linemod_pose_estimation_tpu_torch.models.detector import Detector
    from linemod_pose_estimation_tpu_torch.models.serving import BatchedMatcher, slice_settings
    from linemod_pose_estimation_tpu_torch.ops import match as M
    from linemod_pose_estimation_tpu_torch.utils import scenes as S

    if matcher is None:
        det = Detector.read(BANK)
        cid = det.class_ids[0]
        bank = det.bank(cid)
        det.attach_bank(bank.tile(-(-10240 // bank.num_templates), TILE_TO))
        matcher = BatchedMatcher(det, cid, THRESHOLD, B_MAIN, device=dev,
                                 **slice_settings(B_MAIN))
        rgbs_np, deps_np, _ = S.bin_picking_batch(B_MAIN, seed=3)
        rgbs, deps = torch.from_numpy(rgbs_np).to(dev), torch.from_numpy(deps_np).to(dev)
    _, R1 = M.preprocess_frames_batched(rgbs, deps, use_depth=True)
    T, Kc = matcher.T1, matcher.Kc1
    exact = matcher.weights.exact
    require(exact.dense is None, "the card's exact weights hold a dense one-hot operand")
    dense = M.MatmulWeight.from_kn(M.build_gemm_weights(matcher.feats1, R1.shape[1], T, Kc))
    B, P = R1.shape[0], (R1.shape[2] // T) * (R1.shape[3] // T)
    g = torch.Generator().manual_seed(EXACT_POOL_SEED)
    frame = torch.sort(torch.randint(0, B, (EXACT_POOL_ROWS,), generator=g)).values.to(dev)
    pos = torch.randint(0, P, (EXACT_POOL_ROWS,), generator=g).to(dev)
    n = exact.n
    perf["exact_scores"][f"every_cell_{B}x{n}"] = exact_scores_vs_plain(
        R1, exact.table, dense, T, Kc)
    perf["exact_scores"][f"pool_{EXACT_POOL_ROWS}x{n}"] = exact_scores_vs_plain(
        R1, exact.table, dense, T, Kc, frame, pos)
    del dense
    emit("exact_vs_plain", XS=perf["exact_scores"])


def select_phase(dev: torch.device, perf: dict) -> None:
    """Phase 2e: TK against its plain twin on XS's scores of 32 six-object
    frames over the tiled bank (batch32-fullbin's shape), both timed, with
    the bound and the library call at the plain chain's core."""
    from linemod_pose_estimation_tpu_torch.models.detector import Detector
    from linemod_pose_estimation_tpu_torch.models.serving import BatchedMatcher, slice_settings
    from linemod_pose_estimation_tpu_torch.ops import cuda_kernels as CK
    from linemod_pose_estimation_tpu_torch.ops import match as M
    from linemod_pose_estimation_tpu_torch.ops import roofline as RL
    from linemod_pose_estimation_tpu_torch.utils import scenes as S

    det = Detector.read(BANK)
    cid = det.class_ids[0]
    bank = det.bank(cid)
    det.attach_bank(bank.tile(-(-10240 // bank.num_templates), TILE_TO))
    m = BatchedMatcher(det, cid, THRESHOLD, B_MAIN, device=dev, **slice_settings(B_MAIN))
    rgbs, deps, _ = S.bin_picking_batch(B_MAIN, seed=SELECT_SEED, objects=6)
    _, R1 = M.preprocess_frames_batched(torch.from_numpy(rgbs).to(dev),
                                        torch.from_numpy(deps).to(dev), use_depth=True)
    Hc, Wc = R1.shape[2] // m.T1, R1.shape[3] // m.T1
    raw = M.coarse_scores_gemm_flat_batched(R1, m.weights.exact, m.T1, m.Kc1)
    del R1
    B, P, N = raw.shape
    vpos, scale, k = m._vpos_flat(Hc, Wc), M._sim_scale(m.feats1.count), m.top_k
    kern = lambda: CK.select_topk(raw, scale, vpos, k)
    plain = lambda: CK.select_topk_plain(raw, scale, vpos, k)
    (vals, idx), (pv, pi) = kern(), plain()
    require(torch.equal(vals.view(torch.int32), pv.view(torch.int32)) and torch.equal(idx, pi),
            "TK differs from its plain twin at the fullbin shape")
    keys = torch.empty((B, P * N), dtype=torch.int64, device=dev)
    inv = 0xFFFFFFFF - torch.arange(P * N, device=dev, dtype=torch.int64)
    for b in range(B):
        bits = torch.where(vpos, raw[b].float() * scale, -1.0).view(torch.int32).reshape(-1)
        keys[b] = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).to(torch.int64) * (1 << 32) + inv
    require(torch.equal(torch.topk(keys, k, dim=-1).indices, pi),
            "torch.topk over the keys differs from the plain twin")
    perf["select_topk"][f"fullbin_{B}x{P}x{N}_k{k}"] = dict(
        **kernel_times(kern, "select_", reps=10, per_call=6), plain_ms=cuda_ms(plain, 2),
        library_ms=cuda_ms(lambda: torch.topk(keys, k, dim=-1), 3), max_abs_err=0,
        valid=int((vals >= THRESHOLD - 5.0).sum()), bound=RL.select_topk(B, P, N, k)._asdict())
    del keys, raw
    emit("select_vs_plain", TK=perf["select_topk"])


def peak_bytes(fn) -> int:
    """The device memory fn() allocates at its peak beyond what was
    allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def bound_margins_vs_plain(args) -> dict:
    """BM on one launch's operands against its plain twin (torch._int_mm
    and the (M, N) epilogue it replaced: plain_ms, also library_ms),
    bitwise, both timed, with torch._int_mm alone (gemm_ms), the launch's
    bound over its live rows, and the memory each allocates at its peak:
    the kernel's must stay under one (M, N) bool mask."""
    from linemod_pose_estimation_tpu_torch.ops import cuda_kernels as CK
    from linemod_pose_estimation_tpu_torch.ops import roofline as RL

    A, nk, n, t, vpos, pos, keep, sentinel = args
    kern = lambda: CK.bound_margins(*args)
    plain = lambda: CK.bound_margins_plain(*args)
    err = max_abs_err(kern(), plain())
    require(err == 0, f"BM differs from its plain twin at {tuple(A.shape)} x {n}")
    M, K = A.shape
    live = M if keep is None else int(keep.sum())
    peak, plain_peak = peak_bytes(kern), peak_bytes(plain)
    require(peak < M * n, f"BM allocated {peak} bytes at {M} x {n}: an (M, N) operand")
    plain_ms = cuda_ms(plain, 3)
    return dict(**kernel_times(kern, "bound_margins"), plain_ms=plain_ms, library_ms=plain_ms,
                gemm_ms=cuda_ms(lambda: CK.int8_product(A, nk, n), 3), max_abs_err=err,
                rows=M, live_rows=live, templates=n, contraction=K, peak_bytes=peak,
                plain_peak_bytes=plain_peak,
                bound=RL.bound_margins(live, n, K, vpos.shape[0])._asdict())


def bounds_phase(dev: torch.device, perf: dict, matcher=None, rgbs=None, deps=None) -> None:
    """Phase 2f: BM on the operands of its three launches in one pooled
    B=32 batch over the tiled bank (phase 2b's matcher and frames, built
    here when not given), captured from the call, against its plain twin;
    the group and cell tiers' peak device memory (pool_plan_grouped's,
    under the (M, N) int32 bound they held before); then the odd operand
    sets."""
    from linemod_pose_estimation_tpu_torch.models.detector import Detector
    from linemod_pose_estimation_tpu_torch.models.serving import BatchedMatcher, slice_settings
    from linemod_pose_estimation_tpu_torch.ops import cuda_kernels as CK
    from linemod_pose_estimation_tpu_torch.ops import match as M
    from linemod_pose_estimation_tpu_torch.utils import kernel_cases as KC
    from linemod_pose_estimation_tpu_torch.utils import scenes as S

    if matcher is None:
        det = Detector.read(BANK)
        cid = det.class_ids[0]
        bank = det.bank(cid)
        det.attach_bank(bank.tile(-(-10240 // bank.num_templates), TILE_TO))
        matcher = BatchedMatcher(det, cid, THRESHOLD, B_MAIN, device=dev,
                                 **slice_settings(B_MAIN))
        rgbs_np, deps_np, _ = S.bin_picking_batch(B_MAIN, seed=3)
        rgbs, deps = torch.from_numpy(rgbs_np).to(dev), torch.from_numpy(deps_np).to(dev)
    matcher.candidates(rgbs, deps)  # warm-up
    calls = calls_of([(CK, "bound_margins"), (M, "pool_plan_grouped")],
                     lambda: matcher.candidates(rgbs, deps))
    launches = calls.get("bound_margins", [])
    require(len(launches) == 3, f"a pooled batch launched BM {len(launches)} times, not 3")
    (tiers,) = calls["pool_plan_grouped"]
    tiers_peak = peak_bytes(lambda: M.pool_plan_grouped(*tiers))
    P = launches[0][4].shape[0]
    rows_x_templates = B_MAIN * P * matcher.weights.W_cell.n
    require(tiers_peak < rows_x_templates,
            f"the group and cell tiers allocated {tiers_peak} bytes: an (M, N) operand")
    for name, args in zip(("group", "cell", "fine"), launches):
        A, _, n = args[:3]
        perf["bound_margins"][f"{name}_{A.shape[0]}x{n}x{A.shape[1]}"] = \
            bound_margins_vs_plain(args)
    del calls, launches, tiers
    for name in KC.BOUND_MARGIN_CASES:
        args = KC.bound_margin_case(name, dev)
        require(max_abs_err(CK.bound_margins(*args), CK.bound_margins_plain(*args)) == 0,
                f"BM differs from its plain twin on {name}")
    perf["bound_margins"]["odd_cases"] = dict(max_abs_err=0, cases=list(KC.BOUND_MARGIN_CASES))
    emit("bounds_vs_plain", BM=perf["bound_margins"], tiers_peak_bytes=tiers_peak,
         cell_tier_int32_bytes=4 * rows_x_templates)


def raster_times(coefs, w: int, h: int) -> dict:
    from linemod_pose_estimation_tpu_torch.ops import raster as RA

    return dict(**kernel_times(lambda: RA.raster_zbuffer(coefs, w, h), "raster_zbuffer",
                               per_call=3),
                plain_ms=cuda_ms(lambda: RA.raster_zbuffer_plain(coefs, w, h), 3),
                bound=raster_bound(coefs, w, h)._asdict())


def calls_of(targets, fn, results: bool = False) -> dict:
    """Run fn() with each (module, name) of `targets` wrapped, and return
    {name: [positional args of each call]} (or, with `results`, what each
    call returned); the wrapped functions run as they are (and count their
    launches)."""
    seen, saved = {}, []
    for mod, name in targets:
        orig = getattr(mod, name)
        saved.append((mod, name, orig))

        def spy(*a, _name=name, _orig=orig, **k):
            out = _orig(*a, **k)
            seen.setdefault(_name, []).append(out if results else a)
            return out

        setattr(mod, name, spy)
    try:
        fn()
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)
    return seen


def golden_stage_errors(st, gold: dict, prefix: str, i: int, what: str) -> list:
    """One detect's StageOutputs against row i of a cascade golden: the
    ClusterSet's integer fields, the valid flags and rects must be equal
    (raises otherwise); returns each valid lane's (degrees, mm) off the
    golden pose."""
    for name in ("count", "bbox", "valid", "member_idx", "member_valid"):
        require(np.array_equal(getattr(st.clusters, name).cpu().numpy(),
                               gold[prefix + "c_" + name][i]),
                f"{what}: ClusterSet.{name} differs from the reference")
    for name in ("valid", "rect"):
        require(np.array_equal(getattr(st.poses, name).cpu().numpy(),
                               gold[prefix + "p_" + name][i]),
                f"{what}: ClusterPose.{name} differs from the reference")
    return [pose_err(st.poses.pose[lane].cpu().numpy(), gold[prefix + "p_pose"][i][lane])
            for lane in np.nonzero(gold[prefix + "p_valid"][i])[0]]


def options_phase(dev: torch.device, perf: dict) -> dict:
    """Phase 10 (the cascade's non-default options); adds K4's rows at the
    accuracy detect's shapes to `perf` and returns the launch counts of
    one accuracy detect."""
    from linemod_pose_estimation_tpu_torch.models import cascade as TC
    from linemod_pose_estimation_tpu_torch.models.detector import Detector
    from linemod_pose_estimation_tpu_torch.models.pipeline import DetectionPipeline
    from linemod_pose_estimation_tpu_torch.models.templates import TemplateBank
    from linemod_pose_estimation_tpu_torch.ops import local_descriptor as TL
    from linemod_pose_estimation_tpu_torch.ops import raster as RA
    from linemod_pose_estimation_tpu_torch.utils import pointcloud as TP
    from linemod_pose_estimation_tpu_torch.utils import scenes as S
    from linemod_pose_estimation_tpu_torch.utils import tracing

    with np.load(CASCADE_GOLDEN) as z:
        cg = {k: z[k] for k in z.files}
    with np.load(OPTIONS_GOLDEN) as z:
        og = {k: z[k] for k in z.files}
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    det = Detector.read(BANK, device=dev)
    meta, glob = TemplateBank.read_params_yaml(PARAMS)
    mesh = S.cuboid_mesh()
    thr = float(cg["threshold"])
    make = lambda options: DetectionPipeline(det, meta, glob, mesh, TC.CascadeParams(**options))
    base = make({})
    clouds = [TP.depth_to_cloud(TP.true_div(f32(d), 1000.0), base.K_render)
              for d in cg["depth_mm"]]
    detect = lambda pipe, f, **kw: pipe.detect(cg["rgb"][f], clouds[f], threshold=thr,
                                               depth_mm=cg["depth_mm"][f], **kw)
    spied = [(TC, n) for n in ("icp_two_stage", "icp_two_stage_plane",
                               "icp_nonlinear_schedule")]
    spied.append((TL, "get_pose_by_local_descriptor"))

    def median_ms(pipe) -> float:
        return float(np.median(timed(lambda: detect(pipe, 0), 5)))

    detect(base, 0)  # warm-up
    rows = {"default": dict(options={}, detect_ms_median_of_5=median_ms(base))}
    tracing.reset()
    detect(base, 0)
    rows["default"]["launches_per_detect"] = tracing.launches()
    outside, pipes, launches_acc = [], {}, None
    for cfg, (options, frame_ids) in TC.GOLDEN_OPTION_SETS.items():
        require(tuple(og[cfg + "_frames"]) == tuple(frame_ids),
                f"{cfg}: the golden holds other frames")
        pipe = pipes[cfg] = make(options)
        detect(pipe, 0)  # warm-up
        torch.cuda.synchronize()
        tracing.reset()
        results = [detect(pipe, f, return_stages=True) for f in frame_ids]
        torch.cuda.synchronize()
        launches = tracing.launches()
        for k in ("quantize_cg", "spread_response", "walk_scores", "raster_zbuffer"):
            require(launches[k] > 0, f"kernel {k} was not launched by the {cfg} detect")
        frames = []
        for i, (f, (dets, st)) in enumerate(zip(frame_ids, results)):
            what = f"{cfg} frame {f}"
            for name, a in st.matches._asdict().items():
                require(np.array_equal(a.cpu().numpy(), cg["m_" + name][f]),
                        f"{what}: Matches.{name} differs from the reference")
            errs = golden_stage_errors(st, og, cfg + "_", i, what)
            for name, a in (("nms_keep", st.nms_keep), ("cluster_order", st.cluster_order)):
                require(np.array_equal(a, og[f"{cfg}_{name}"][i]),
                        f"{what}: {name} differs from the reference")
            require((len(dets) >= 1) == (int(cg["templates"][f]) >= 0),
                    f"{what}: {len(dets)} detections")
            tol = OPTION_POSE_TOL.get(cfg, POSE_TOL)
            outside += [(what, e) for e in errs if e[0] > tol[0] or e[1] > tol[1]]
            frames.append(dict(frame=f, detections=len(dets), lanes=int(st.poses.valid.numel()),
                               pose_vs_reference=[dict(deg=a, mm=b) for a, b in errs]))
        tracing.reset()
        icp = calls_of(spied, lambda: detect(pipe, 0), results=True)
        ld = icp.pop("get_pose_by_local_descriptor", [])
        per_detect = tracing.launches()
        if cfg == "accuracy":
            launches_acc = per_detect
        rows[cfg] = dict(
            options=options, frames=frames, launches=launches, launches_per_detect=per_detect,
            icp_iterations_per_lane={k: [r.iterations.tolist() for r in v]
                                     for k, v in icp.items()},
            local_descriptor_per_lane=[dict(valid=r.valid.tolist(), votes=r.votes.tolist(),
                                            correspondences=r.n_correspondences.tolist())
                                       for r in ld],
            detect_ms_median_of_5=median_ms(pipe),
            pose_tolerance_deg_mm=OPTION_POSE_TOL.get(cfg, POSE_TOL))
    emit("cascade_options_golden", equal_matches_clusters_valid_rect=True, configurations=rows,
         poses_outside_tolerance=outside)
    require(not outside, f"cascade options: poses off the reference: {outside}")

    # K4 on the operands the accuracy detect passes it: 16 lanes, and the
    # refinement round's render, one intrinsic matrix per lane.
    renders = calls_of([(RA, "raster_zbuffer")],
                       lambda: detect(pipes["accuracy_refine"], 0))["raster_zbuffer"]
    require(len(renders) == 2, f"accuracy_refine: {len(renders)} K4 calls a detect, not 2")
    for name, (coefs, w, h) in zip(("accuracy_captured", "refine_round_captured"), renders):
        lanes = 2 * 2 * TC.CascadeParams().max_clusters
        require(coefs.shape[0] == lanes, f"K4 {name}: {coefs.shape[0]} lanes, not {lanes}")
        perf["raster_zbuffer"][name] = dict(**raster_vs_plain(coefs, w, h, name),
                                            **raster_times(coefs, w, h))
    emit("accuracy_kernel_operands",
         K4={k: perf["raster_zbuffer"][k] for k in ("accuracy_captured",
                                                    "refine_round_captured")})

    # The in-plane sweep repair on the two real tail views, on the card.
    sweeps = {}
    for stem, true_deg in SWEEP_CLOUDS.items():
        with np.load(os.path.join(REPO, "data", stem + ".npz")) as z:
            args = [torch.from_numpy(z[k]).to(dev)
                    for k in ("model", "mvalid", "scene", "snorm", "svalid")]
        T_fix, applied = TC.inplane_sweep_fix(*args, torch.tensor(True, device=dev), 6.0, 0.7)
        deg = pose_err(T_fix.cpu().numpy(), np.eye(4))[0]
        require(bool(applied) and abs(deg - true_deg) < 0.5,
                f"inplane_sweep_fix {stem}: applied={bool(applied)}, {deg} deg vs {true_deg}")
        sweeps[stem] = dict(applied=True, correction_deg=deg, expected_deg=true_deg)
    emit("inplane_sweep_real_clouds", views=sweeps, tolerance_deg=0.5)

    # Control: with TF32 matmuls the accuracy frames, and the LM frame with
    # its wider limit, must leave their tolerances.
    control = {}
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        for cfg in ("accuracy", "nonlinear"):
            worst = [0.0, 0.0]
            for i, f in enumerate(TC.GOLDEN_OPTION_SETS[cfg][1]):
                st = detect(pipes[cfg], f, return_stages=True)[1]
                if not np.array_equal(st.poses.valid.cpu().numpy(), og[cfg + "_p_valid"][i]):
                    worst = [float("inf")] * 2
                    continue
                for lane in np.nonzero(og[cfg + "_p_valid"][i])[0]:
                    e = pose_err(st.poses.pose[lane].cpu().numpy(),
                                 og[cfg + "_p_pose"][i][lane])
                    worst = [max(worst[0], e[0]), max(worst[1], e[1])]
            control[cfg] = dict(worst_deg=worst[0], worst_mm=worst[1],
                                pose_tolerance_deg_mm=OPTION_POSE_TOL.get(cfg, POSE_TOL))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    emit("tf32_control_options", configurations=control)
    for cfg, c in control.items():
        tol = c["pose_tolerance_deg_mm"]
        require(c["worst_deg"] > tol[0] or c["worst_mm"] > tol[1],
                f"TF32 control ({cfg}): poses within {tol} of the reference ({c}); "
                "the limit does not see reduced precision")
    return launches_acc


def cascade_phases(dev: torch.device, perf: dict) -> dict:
    """Phases 4-6 (K4, K2b, the cascade golden); fills `perf` and returns
    the launch counts of the checked detect run."""
    from linemod_pose_estimation_tpu_torch.models import cascade as TC
    from linemod_pose_estimation_tpu_torch.models.pipeline import DetectionPipeline
    from linemod_pose_estimation_tpu_torch.models.renderer import _pad_triangles
    from linemod_pose_estimation_tpu_torch.models.templates import TemplateBank
    from linemod_pose_estimation_tpu_torch.ops import cuda_kernels as CK
    from linemod_pose_estimation_tpu_torch.ops import cuda_preprocess as CP
    from linemod_pose_estimation_tpu_torch.ops import features as F
    from linemod_pose_estimation_tpu_torch.ops import match as M
    from linemod_pose_estimation_tpu_torch.ops import raster as RA
    from linemod_pose_estimation_tpu_torch.ops import roofline as RL
    from linemod_pose_estimation_tpu_torch.utils import kernel_cases as KC
    from linemod_pose_estimation_tpu_torch.utils import pointcloud as TP
    from linemod_pose_estimation_tpu_torch.utils import scenes as S
    from linemod_pose_estimation_tpu_torch.utils import tracing

    # -- phase 4: K4 vs plain at the cascade's shapes -------------------------
    meta, glob = TemplateBank.read_params_yaml(PARAMS)
    mesh = S.cuboid_mesh()
    tris = torch.from_numpy(_pad_triangles(mesh.triangles, 64)).to(dev)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    Kf = f32([[glob.focal_length_x, 0, glob.width / 2.0],
              [0, glob.focal_length_y, glob.height / 2.0], [0, 0, 1]])
    vp = TC.CascadeParams().render_viewport
    Kv = Kf.clone()
    Kv[0, 2] = Kv[1, 2] = vp / 2.0
    ids = [0, 300, 700, 1000, 1400, 1700, 2000, 2400]
    cases = (
        # detect renders its max_clusters = 4 cluster lanes in one launch
        ("detect_4x256x256", ids[:4], Kv, vp, vp),
        ("cascade_8x256x256", ids, Kv, vp, vp),
        ("frame_640x480", [0], Kf, glob.width, glob.height),
        ("offscreen", None, Kv, vp, vp),
    )
    for name, sel, K, w, h in cases:
        if sel is None:
            R, T = torch.eye(3, device=dev)[None], f32([[10.0, 0.0, 0.5]])
        else:
            R, T = f32(meta.R[sel]), f32(meta.T[sel])
        coefs = RA.triangle_coefficients(tris, R, T, K.expand(R.shape[0], 3, 3))
        perf["raster_zbuffer"][name] = raster_vs_plain(coefs, w, h, name)
        if sel is None:
            require(perf["raster_zbuffer"][name]["covered"] == 0,
                    "K4 offscreen: a pixel was covered")
        else:
            perf["raster_zbuffer"][name].update(raster_times(coefs, w, h))
    odd = {name: raster_vs_plain(coefs, w, h, name)
           for name, (coefs, w, h) in KC.raster_cases(dev, PARAMS).items()}
    perf["raster_zbuffer"]["odd_cases"] = dict(
        max_abs_err=max(v["max_abs_err"] for v in odd.values()), cases=odd)
    emit("raster_vs_plain", K4=perf["raster_zbuffer"])

    # -- phase 5: K2b, the single-frame preprocess, kernels vs plain ---------
    with np.load(CASCADE_GOLDEN) as z:
        cg = {k: z[k] for k in z.files}
    rgb0, dep0 = torch.from_numpy(cg["rgb"][0]).to(dev), f32(cg["depth_mm"][0])
    for use_depth in (False, True):
        got = M.preprocess_frame(rgb0, dep0, use_depth=use_depth)
        ref = M.preprocess_frame(rgb0, dep0, use_depth=use_depth, plain=True)
        for fname, a, b in zip(got._fields, got, ref):
            require(torch.equal(a, b), f"K2b preprocess_frame {fname} "
                    f"(use_depth={use_depth}) differs from plain")
    g0 = CP.quantize_color_gradient(rgb0[None], 10.0)
    g1 = CP.quantize_color_gradient(torch.stack(
        [F.pyr_down(rgb0[None, ..., c].float()) for c in range(3)], -1).contiguous(), 10.0)
    n0 = F.quantize_depth_normal(dep0[None])
    for name, q, T in (("grad_T5_480x640", g0, 5), ("grad_T8_240x320", g1, 8),
                       ("norm_T5_480x640", n0, 5),
                       ("norm_T8_240x320", n0[:, ::2, ::2].contiguous(), 8)):
        err = max_abs_err(CK.spread_response(q, T), CK.spread_response_plain(q, T))
        require(err == 0, f"K2b {name} differs from its plain version")
        perf["spread_response_b1"][name] = dict(
            **kernel_times(lambda: CK.spread_response(q, T), "spread_response_kernel"),
            plain_ms=cuda_ms(lambda: CK.spread_response_plain(q, T), 3),
            max_abs_err=err, bound=RL.spread_response(*q.shape, T)._asdict())
    emit("single_frame_preprocess_vs_plain", equal=True, K2b=perf["spread_response_b1"])

    # -- phase 6: the cascade golden at full width ---------------------------
    t0 = time.perf_counter()
    pipe = DetectionPipeline.from_files(BANK, PARAMS, mesh, device=dev)
    thr = float(cg["threshold"])
    clouds = [TP.depth_to_cloud(TP.true_div(f32(d), 1000.0), pipe.K_render)
              for d in cg["depth_mm"]]
    frames = [(cg["rgb"][f], clouds[f], cg["depth_mm"][f]) for f in range(len(clouds))]
    pipe.detect(*frames[0][:2], threshold=thr, depth_mm=frames[0][2])  # warm-up
    torch.cuda.synchronize()
    setup6_s = time.perf_counter() - t0
    tracing.reset()
    results = [pipe.detect(r, c, threshold=thr, depth_mm=d, return_stages=True)
               for r, c, d in frames]
    torch.cuda.synchronize()
    launches6 = tracing.launches()
    for k in ("quantize_cg", "spread_response", "walk_scores", "raster_zbuffer"):
        require(launches6[k] > 0, f"kernel {k} was not launched by detect")
    per_frame = []
    for f, (dets, st) in enumerate(results):
        for name, a in st.matches._asdict().items():
            require(np.array_equal(a.cpu().numpy(), cg["m_" + name][f]),
                    f"frame {f}: Matches.{name} differs from the reference")
        for name in ("count", "bbox", "valid", "member_idx", "member_valid"):
            require(np.array_equal(getattr(st.clusters, name).cpu().numpy(),
                                   cg["c_" + name][f]),
                    f"frame {f}: ClusterSet.{name} differs from the reference")
        for name in ("valid", "rect"):
            require(np.array_equal(getattr(st.poses, name).cpu().numpy(), cg["p_" + name][f]),
                    f"frame {f}: ClusterPose.{name} differs from the reference")
        lanes = []
        for lane in np.nonzero(cg["p_valid"][f])[0]:
            d = pose_err(st.poses.pose[lane].cpu().numpy(), cg["p_pose"][f][lane])
            require(d[0] <= POSE_TOL[0] and d[1] <= POSE_TOL[1],
                    f"frame {f} lane {lane}: pose off the reference by {d}")
            lanes.append(d)
        tid = int(cg["templates"][f])
        require((len(dets) >= 1) == (tid >= 0),
                f"frame {f}: {len(dets)} detections (template {tid})")
        row = dict(frame=f, template=tid, detections=len(dets),
                   valid_matches=int(st.matches.valid.sum()),
                   pose_vs_reference=[dict(deg=a, mm=b) for a, b in lanes])
        if tid >= 0:
            # planted pose, canonicalized as the cascade canonicalizes its output
            gt = np.eye(4)
            gt[:3, :3] = TC.canonicalize(torch.tensor(meta.R[tid]), "x_front").numpy()
            gt[:3, 3] = meta.R[tid] @ meta.T[tid]
            top = int(np.argmax(np.where(cg["p_valid"][f], cg["p_score"][f], -np.inf)))
            row["top_vs_planted"] = dict(zip(("deg", "mm"), pose_err(dets[0].pose, gt)))
            row["reference_top_vs_planted"] = dict(
                zip(("deg", "mm"), pose_err(cg["p_pose"][f][top], gt)))
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                pipe.detect(*frames[f][:2], threshold=thr, depth_mm=frames[f][2])
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            row["detect_ms_median_of_5"] = float(np.median(times))
            row["detect_ms"] = times
        per_frame.append(row)
    tracing.reset()
    pipe.detect(*frames[0][:2], threshold=thr, depth_mm=frames[0][2])
    per_detect = tracing.launches()
    emit("cascade_golden", equal_matches=True, frames=per_frame, launches=launches6,
         launches_per_detect=per_detect, setup_s=setup6_s,
         pose_tolerance_deg_mm=POSE_TOL)

    # K3 and K4 on the operands one detect gives them (frame 0).
    got = calls_of([(CK, "walk_scores"), (RA, "raster_zbuffer")],
                   lambda: pipe.detect(*frames[0][:2], threshold=thr,
                                       depth_mm=frames[0][2]))
    R0d, *opsd, Td = got["walk_scores"][0]
    err = max_abs_err(CK.walk_scores(R0d, *opsd, Td), CK.walk_scores_plain(R0d, *opsd, Td))
    require(err == 0, "K3 at detect's walk differs from its plain version")
    perf["walk_scores"]["detect_B1"] = dict(
        **kernel_times(lambda: CK.walk_scores(R0d, *opsd, Td), "walk_scores_kernel"),
        plain_ms=cuda_ms(lambda: CK.walk_scores_plain(R0d, *opsd, Td), 3),
        max_abs_err=err, slots_walked=int(opsd[-1].sum()), shape=list(opsd[0].shape),
        bound=walk_bound(R0d, opsd, Td)._asdict())
    coefs, w, h = got["raster_zbuffer"][0]
    perf["raster_zbuffer"]["detect_captured"] = dict(
        **raster_vs_plain(coefs, w, h, "detect_captured"), **raster_times(coefs, w, h))
    emit("detect_kernel_operands", K3=perf["walk_scores"]["detect_B1"],
         K4=perf["raster_zbuffer"]["detect_captured"])

    # -- control: TF32 matmuls must break POSE_TOL ----------------------------
    worst = [0.0, 0.0]
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        for f, (r, c, d) in enumerate(frames):
            st = pipe.detect(r, c, threshold=thr, depth_mm=d, return_stages=True)[1]
            if not np.array_equal(st.poses.valid.cpu().numpy(), cg["p_valid"][f]):
                worst = [float("inf")] * 2
                continue
            for lane in np.nonzero(cg["p_valid"][f])[0]:
                e = pose_err(st.poses.pose[lane].cpu().numpy(), cg["p_pose"][f][lane])
                worst = [max(worst[0], e[0]), max(worst[1], e[1])]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    require(worst[0] > POSE_TOL[0] or worst[1] > POSE_TOL[1],
            f"TF32 control: poses within {POSE_TOL} of the reference ({worst}); "
            "the limit does not see reduced precision")
    emit("tf32_control", worst_deg=worst[0], worst_mm=worst[1],
         pose_tolerance_deg_mm=POSE_TOL, outside=True)
    return per_detect


def odd_shapes(dev: torch.device) -> list[str]:
    """K1 (u8 and f32 input) and K2 (T=5 and 8) against their plain
    versions, bitwise, on ODD_SHAPES.  Each K2 call writes into channels
    [5, 13) of a 19-channel stack, whose other channels must keep their
    bytes."""
    from linemod_pose_estimation_tpu_torch.ops import cuda_kernels as CK
    from linemod_pose_estimation_tpu_torch.ops import cuda_preprocess as CP

    gen = torch.Generator(device=dev).manual_seed(1)
    for H, W in ODD_SHAPES:
        x = torch.randint(0, 256, (2, H, W, 3), generator=gen, device=dev, dtype=torch.uint8)
        yy = torch.arange(H, device=dev)[:, None].float()
        xx = torch.arange(W, device=dev)[None, :].float()
        x[1, ..., 0] = ((torch.sin(yy / 3.0) + torch.cos(xx / 4.0)) * 60 + 128).to(torch.uint8)
        for kind, xi in (("u8", x), ("f32", x.float())):
            err = max_abs_err(CP.quantize_color_gradient(xi, 10.0),
                              CP.quantize_color_gradient_plain(xi, 10.0))
            require(err == 0, f"K1 {H}x{W} {kind} differs from its plain version")
        q = ((1 << torch.randint(0, 8, (2, H, W), generator=gen, device=dev))
             * (torch.rand((2, H, W), generator=gen, device=dev) < 0.3)).to(torch.uint8)
        for T in (5, 8):
            stack = torch.full((2, 19, H, W), 0xAB, dtype=torch.uint8, device=dev)
            CK.spread_response(q, T, out=stack, channel=5)
            require(torch.equal(stack[:, 5:13], CK.spread_response_plain(q, T)),
                    f"K2 {H}x{W} T={T} differs from its plain version")
            require(bool((stack[:, :5] == 0xAB).all()) and bool((stack[:, 13:] == 0xAB).all()),
                    f"K2 {H}x{W} T={T} wrote outside its channel slice")
    return [f"{H}x{W}" for H, W in ODD_SHAPES]


def distinct_reads(shape, reads) -> int:
    """Distinct bytes of a (B, C, H, W) u8 stack that a kernel reads:
    `reads` yields (plane (N,) = b * C + c, rows (N, n), cols (N, n)), each
    the n x n grid rows x cols of one plane; reads past the frame (zero by
    definition) do not count."""
    B, C, H, W = shape
    seen = None
    for plane, ys, xs in reads:
        if seen is None:
            seen = torch.zeros(B * C * H * W, dtype=torch.bool, device=plane.device)
        ok = ((ys >= 0) & (ys < H))[:, :, None] & ((xs >= 0) & (xs < W))[:, None, :]
        idx = ((plane.long()[:, None, None] * H + ys.long().clamp(0, H - 1)[:, :, None]) * W
               + xs.long().clamp(0, W - 1)[:, None, :])
        seen[idx[ok]] = True
    return 0 if seen is None else int(seen.sum())


def walk_bound(R0, ops, T: int):
    """K3's bound on one launch's operands (ops/roofline.py): the walked
    slots (k < n_valid[b]), their live features, the bytes they read."""
    from linemod_pose_estimation_tpu_torch.ops import roofline as RL
    oris, dys, dxs, live, gy0, gx0, n_valid = ops
    B, C = R0.shape[:2]
    K, Fmax = oris.shape[1:]
    slot_ok = torch.arange(K, device=R0.device)[None, :] < n_valid[:, None]
    q = torch.arange(16, device=R0.device)
    frame = torch.arange(B, device=R0.device)[:, None].expand(B, K)

    def reads():
        for f in range(Fmax):
            sel = slot_ok & live[..., f]
            yield ((frame * C + oris[..., f])[sel],
                   ((gy0[..., None] + q) * T + dys[..., f, None])[sel],
                   ((gx0[..., None] + q) * T + dxs[..., f, None])[sel])

    live_pairs = int((slot_ok[..., None] & live).sum())
    return RL.walk_scores(B, K, Fmax, int(slot_ok.sum()), live_pairs,
                          distinct_reads(R0.shape, reads()))


def window_bound(R0, plan, window: int):
    """K5's bound on one window plan (ops/roofline.py)."""
    from linemod_pose_estimation_tpu_torch.ops import roofline as RL
    C = R0.shape[1]
    K, Fmax = plan.oris.shape
    q = torch.arange(window, device=R0.device)

    def reads():
        for f in range(Fmax):
            sel = f < plan.nf
            yield ((plan.frame_idx * C + plan.oris[:, f])[sel],
                   (plan.anchor_y[:, None] + plan.dys[:, f, None] + q)[sel],
                   (plan.anchor_x[:, None] + plan.dxs[:, f, None] + q)[sel])

    return RL.refine_scores(K, Fmax, window, int(plan.nf.clamp(max=Fmax).sum()),
                            distinct_reads(R0.shape, reads()))


def raster_bound(coefs, W: int, H: int):
    """K4's bound (ops/roofline.py): the (pixel, live triangle) pairs whose
    pixel centre lies in the triangle's grown bounding box."""
    from linemod_pose_estimation_tpu_torch.ops import raster as RA
    from linemod_pose_estimation_tpu_torch.ops import roofline as RL

    col = lambda name: coefs[..., RA.COEFS.index(name)]
    nx = (torch.floor(col("xmax") - 0.5).clamp(max=W - 1)
          - torch.ceil(col("xmin") - 0.5).clamp(min=0) + 1).clamp(min=0)
    ny = (torch.floor(col("ymax") - 0.5).clamp(max=H - 1)
          - torch.ceil(col("ymin") - 0.5).clamp(min=0) + 1).clamp(min=0)
    n = nx * ny
    pairs = int(torch.where((col("live") > 0.5) & torch.isfinite(n), n, 0).sum())
    P, Tn, ncoef = coefs.shape
    return RL.raster_zbuffer(P, Tn, H, W, ncoef, pairs)


def timed(fn, reps: int = 1) -> list[float]:
    """Host-clock ms of `reps` calls of fn(), each ended by a device sync."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def event_times(fn, reps: int = 3) -> list[float]:
    """Device ms of `reps` calls of fn(), each between its own pair of CUDA
    events (the caller has warmed fn up)."""
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(stop))
    return out


def valid_set(m) -> collections.Counter:
    """The valid matches of a Matches record as a multiset of (frame,
    template, x, y, similarity): candidates of neighbouring cells may walk
    to one match, so an entry can count more than once."""
    v = m.valid.cpu().numpy()
    frame = np.broadcast_to(np.arange(v.shape[0])[:, None], v.shape)[v]
    cols = [a.cpu().numpy()[v] for a in (m.template_id, m.x, m.y, m.similarity)]
    return collections.Counter(zip(frame.tolist(), *(c.tolist() for c in cols)))


def golden_frames(dev: torch.device):
    with np.load(CASCADE_GOLDEN) as z:
        return torch.from_numpy(z["rgb"]).to(dev), torch.from_numpy(z["depth_mm"]).to(dev)


def check_golden(gold: dict, prefix: str, m, what: str) -> None:
    for name, a in m._asdict().items():
        require(np.array_equal(a.cpu().numpy(), gold[prefix + name]),
                f"{what}: {name} differs from the reference")


def k5_phase(dev, det, bank, rgbs, deps, perf: dict) -> dict:
    """Phase 7 (the K5 path); fills perf["refine_scores"] and returns the
    launch counts of the K5 chain's run."""
    from linemod_pose_estimation_tpu_torch.models.detector import Detector
    from linemod_pose_estimation_tpu_torch.models.serving import BatchedMatcher
    from linemod_pose_estimation_tpu_torch.ops import cuda_kernels as CK
    from linemod_pose_estimation_tpu_torch.ops import match as M
    from linemod_pose_estimation_tpu_torch.utils import kernel_cases as KC
    from linemod_pose_estimation_tpu_torch.utils import tracing

    cid = bank.class_id
    xm = BatchedMatcher(det, cid, THRESHOLD, B_MAIN, top_k=128, device=dev)
    xp = BatchedMatcher(det, cid, THRESHOLD, B_MAIN, top_k=128, device=dev, plain=True)
    T0, T1, E0 = xm.T0, xm.T1, xm.E0

    def chain(m=xm, plain=False):
        R0, cands, _ = m.candidates(rgbs, deps)
        return R0, cands, M.refine_candidates_pallas_batched(
            R0, m.feats0, cands, T1, THRESHOLD, E0, fine_T=T0, plain=plain)

    chain()  # warm-up
    torch.cuda.synchronize()
    tracing.reset()
    t0 = time.perf_counter()
    R0, cands, m5 = chain()
    torch.cuda.synchronize()
    chain_ms = (time.perf_counter() - t0) * 1e3
    launches = tracing.launches()
    for k in ("quantize_cg", "spread_response", "refine_scores"):
        require(launches[k] > 0, f"kernel {k} was not launched by the K5 chain")
    chain_repeats = timed(chain, 3)
    exhaustive_ms = timed(lambda: xm.match_batch(rgbs, deps), 3)
    R0p, cp, m5p = chain(xp, plain=True)
    require(torch.equal(R0p, R0) and matches_equal(cp, cands),
            "K5 chain: candidates differ from the plain path's")
    require(matches_equal(m5, m5p), "K5 chain: kernel path != plain path")

    K = cands.template_id.numel()
    H, W = R0.shape[-2:]
    plan = M.window_plan(R0.shape, xm.feats0, cands, T1, E0, T0)
    slot = torch.arange(K, device=dev, dtype=torch.int32)
    edge = plan._replace(anchor_y=(H - 1 - slot % 24).to(torch.int32),
                         anchor_x=(W - 1 - slot % 24).to(torch.int32))
    for name, pl in ((f"chain_K{K}", plan), (f"edge_K{K}", edge)):
        run = lambda f: f(R0, *pl.operands(), window=24, frame_idx=pl.frame_idx)
        got, ref = run(CK.refine_scores), run(CK.refine_scores_plain)
        err = max_abs_err(got, ref)
        require(err == 0, f"K5 {name} differs from its plain version")
        perf["refine_scores"][name] = dict(
            max_abs_err=err, nonzero_frac=float((got > 0).float().mean()),
            features=int(pl.nf.sum()))
        if pl is plan:
            perf["refine_scores"][name].update(
                **kernel_times(lambda: run(CK.refine_scores), "refine_scores_kernel"),
                plain_ms=cuda_ms(lambda: run(CK.refine_scores_plain), 3),
                bound=window_bound(R0, pl, 24)._asdict())
    # The chain's plan at a window past one block's threads, and on a
    # response stack one byte into its storage (an odd data pointer).
    R0_odd = torch.empty(R0.numel() + 8, dtype=torch.uint8, device=dev)[1:R0.numel() + 1]
    R0_odd = R0_odd.view(R0.shape).copy_(R0)
    for name, Rx, w in ((f"chain_K{K}_window40", R0, 40), (f"chain_K{K}_odd_ptr", R0_odd, 24)):
        run = lambda f: f(Rx, *plan.operands(), window=w, frame_idx=plan.frame_idx)
        err = max_abs_err(run(CK.refine_scores), run(CK.refine_scores_plain))
        require(err == 0, f"K5 {name} differs from its plain version")
        perf["refine_scores"][name] = dict(max_abs_err=err, data_ptr_mod_4=Rx.data_ptr() % 4)
    del R0_odd
    odd = KC.window_cases(dev)
    for name, (Ro, ops, w, fr) in odd.items():
        err = max_abs_err(CK.refine_scores(Ro, *ops, window=w, frame_idx=fr),
                          CK.refine_scores_plain(Ro, *ops, window=w, frame_idx=fr))
        require(err == 0, f"K5 {name} differs from its plain version")
    perf["refine_scores"]["odd_cases"] = dict(max_abs_err=0, cases=list(odd))
    del odd
    for b in range(B_MAIN):
        cb = M.CoarseMatches(*(a[b] for a in cands))
        want = M.Matches(*(a[b] for a in m5))
        for fname, got in (
                ("gather", M.refine_candidates(R0[b], xm.feats0, cb, T1, THRESHOLD, fine_T=T0)),
                ("slices", M.refine_candidates_slices(R0[b], xm.feats0, cb, T1, THRESHOLD,
                                                      E0, fine_T=T0)),
                ("conv", M.refine_candidates_conv(R0[b], xm.feats0, cb, T1, THRESHOLD,
                                                  E0, fine_T=T0))):
            require(matches_equal(got, want), f"frame {b}: refine_candidates "
                    f"({fname}) differs from the K5 chain")
    emit("k5_chain", batch=B_MAIN, templates=int(xm.feats1.count.numel()),
         candidates=K, equal_kernel_vs_plain=True, refiners_agree=True,
         launches=launches, valid_matches=int(m5.valid.sum()),
         chain_batch_ms=chain_ms, chain_batch_ms_repeats=chain_repeats,
         exhaustive_batch_ms=exhaustive_ms, K5=perf["refine_scores"])
    del xm, xp

    # -- the golden: the untiled bank on the cascade frames ------------------
    with np.load(WINDOW_GOLDEN) as z:
        gold = {k: z[k] for k in z.files}
    g_rgbs, g_deps = golden_frames(dev)
    thr = float(gold["threshold"])
    gd = Detector(bank.params, device=dev)
    gd.attach_bank(bank)
    gm = BatchedMatcher(gd, cid, thr, g_rgbs.shape[0], top_k=int(gold["top_k"]), device=dev)
    R0, cands, _ = gm.candidates(g_rgbs, g_deps)
    check_golden(gold, "x_", gm.refine(R0, cands), "exhaustive match_batch")
    k5 = M.refine_candidates_pallas_batched(R0, gm.feats0, cands, gm.T1, thr, gm.E0,
                                            fine_T=gm.T0)
    check_golden(gold, "k5_", k5, "K5 chain")
    check_golden(gold, "fn_", gd.make_matcher_fn(cid, thr)(g_rgbs[0], g_deps[0]),
                 "make_matcher_fn")
    emit("k5_golden", frames=int(g_rgbs.shape[0]), templates=bank.num_templates,
         equal=True, valid_matches=int(k5.valid.sum()))
    return launches


def two_object_phase(dev, bank, rgbs, deps) -> dict:
    """Phase 8 (the two-object path); returns what phase 9 takes up: the
    two-class detector over the tiled banks, the mixed batch, and the
    merged pooled Matches per class with their batch times."""
    from linemod_pose_estimation_tpu_torch.models.detector import Detector
    from linemod_pose_estimation_tpu_torch.models.serving import (
        BatchedMatcher, MultiClassBatchedMatcher, slice_settings)
    from linemod_pose_estimation_tpu_torch.models.templates import TemplateBank
    from linemod_pose_estimation_tpu_torch.utils import tracing

    cid = bank.class_id
    cid2 = cid + "_second"
    bank2 = TemplateBank(cid2, bank.params, bank.templates, f_cap=bank.f_cap)
    with np.load(WINDOW_GOLDEN) as z:
        gold = {k: z[k] for k in z.files}
    thrs = [float(t) for t in gold["two_object_thresholds"]]
    top_k = int(gold["top_k"])

    def matcher(d, B, **kw):
        return MultiClassBatchedMatcher(d, [cid, cid2], thrs, B, top_k=top_k,
                                        prune_mode="pooled", pool_coarse=56 * B,
                                        pool_fine=36 * B, device=dev, **kw)

    gd = Detector(bank.params, device=dev)
    gd.attach_bank(bank)
    gd.attach_bank(bank2)
    g_rgbs, g_deps = golden_frames(dev)
    gm = matcher(gd, g_rgbs.shape[0])
    out = gm.match_batch(g_rgbs, g_deps)
    for i, c in enumerate((cid, cid2)):
        check_golden(gold, f"mc{i}_", out[c], f"two-object class {c}")
    check_golden(gold, "mc_stats_", gm.last_pool, "two-object PooledStats")
    emit("two_object_golden", frames=int(g_rgbs.shape[0]), templates_per_class=bank.num_templates,
         thresholds=thrs, equal=True, valid_matches=[int(out[c].valid.sum()) for c in (cid, cid2)],
         fallback=bool(gm.last_pool.fallback))
    del gm

    # The bin-picking scenes never reach 92 (best ~84), so the batch's last
    # four frames are the cascade frames, which do: the merged-vs-split and
    # kernel-vs-plain checks then see real matches.
    rgbs = torch.cat([rgbs[:B_MAIN - len(g_rgbs)], g_rgbs])
    deps = torch.cat([deps[:B_MAIN - len(g_deps)], g_deps])
    reps = TILE_TO // bank.num_templates  # as phase 2b tiles
    td = Detector(bank.params, device=dev)
    td.attach_bank(bank.tile(reps, TILE_TO))
    td.attach_bank(bank2.tile(reps, TILE_TO))
    mk, mp = matcher(td, B_MAIN), matcher(td, B_MAIN, plain=True)
    mk.match_batch(rgbs, deps)  # warm-up
    torch.cuda.synchronize()
    tracing.reset()
    t0 = time.perf_counter()
    merged = mk.match_batch(rgbs, deps)
    torch.cuda.synchronize()
    merged_ms = (time.perf_counter() - t0) * 1e3
    launches = tracing.launches()
    for k in ("quantize_cg", "spread_response", "walk_scores"):
        require(launches[k] > 0, f"kernel {k} was not launched by the two-object path")
    stats = mk.last_pool
    merged_repeats = timed(lambda: mk.match_batch(rgbs, deps), 3)
    plain = mp.match_batch(rgbs, deps)
    for c in (cid, cid2):
        require(matches_equal(merged[c], plain[c]), f"two-object {c}: kernel path != plain path")
    require(matches_equal(stats, mp.last_pool), "two-object PooledStats: kernel != plain")
    del mp
    singles = [BatchedMatcher(td, c, t, B_MAIN, device=dev, **slice_settings(B_MAIN))
               for c, t in zip((cid, cid2), thrs)]
    split = lambda: [s.match_batch(rgbs, deps) for s in singles]
    split()  # warm-up
    split_repeats = timed(split, 3)

    for c, single in zip((cid, cid2), split()):
        require(valid_set(merged[c]) == valid_set(single),
                f"two-object {c}: merged valid matches != the single-class batch's")
    emit("two_object_batch", batch=B_MAIN, templates=int(mk.feats1.count.numel()),
         thresholds=thrs, equal_kernel_vs_plain=True, merged_equals_split=True,
         launches=launches, stats={k: v.tolist() for k, v in stats._asdict().items()},
         valid_matches=[int(merged[c].valid.sum()) for c in (cid, cid2)],
         merged_batch_ms=merged_ms, merged_batch_ms_repeats=merged_repeats,
         split_batch_ms_repeats=split_repeats,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    return dict(detector=td, class_ids=(cid, cid2), thresholds=thrs, top_k=top_k,
                rgbs=rgbs, deps=deps, pooled=merged, pooled_ms=merged_repeats)


def prune_phase(dev, det, bank, two: dict) -> dict:
    """Phase 9 (the positions and two_axis modes, the default-mode
    two-object matcher, the RGB-only bank).  `det` holds the tiled bank,
    `bank` is the untiled one, `two` what two_object_phase returned.
    Returns the launch counts of the B=32 `positions` run at its defaults."""
    from linemod_pose_estimation_tpu_torch.models.detector import Detector
    from linemod_pose_estimation_tpu_torch.models.serving import (
        BatchedMatcher, MultiClassBatchedMatcher, slice_settings)
    from linemod_pose_estimation_tpu_torch.models.templates import TemplateBank
    from linemod_pose_estimation_tpu_torch.utils import tracing

    with np.load(PRUNE_GOLDEN) as z:
        gold = {k: z[k] for k in z.files}
    cid = bank.class_id
    thr, top_k = float(gold["threshold"]), int(gold["top_k"])
    settings = {"pos": {}, "fof": dict(fine_pos_cap=int(gold["fine_overflow_cap"])),
                "cof": dict(prune_pos_cap=int(gold["coarse_overflow_cap"])),
                "two": dict(prune_mode="two_axis")}

    # -- the golden: the untiled bank on the cascade frames ------------------
    g_rgbs, g_deps = golden_frames(dev)
    gB = g_rgbs.shape[0]
    gd = Detector(bank.params, device=dev)
    gd.attach_bank(bank)
    valid = {}
    for key, kw in settings.items():
        gm = BatchedMatcher(gd, cid, thr, gB, top_k=top_k, prune=True, device=dev, **kw)
        out = gm.match_batch(g_rgbs, g_deps)
        check_golden(gold, f"{key}_m_", out, f"prune golden {key} Matches")
        check_golden(gold, f"{key}_pp_", gm.last_prune, f"prune golden {key} PrunePlan")
        if key != "two":
            check_golden(gold, f"{key}_fp_", gm.last_fine, f"prune golden {key} FinePlan")
        valid[key] = int(out.valid.sum())
        del gm
    cid2 = two["class_ids"][1]
    gd.attach_bank(TemplateBank(cid2, bank.params, bank.templates, f_cap=bank.f_cap))
    gmc = MultiClassBatchedMatcher(gd, [cid, cid2], two["thresholds"], gB, top_k=top_k,
                                   device=dev)
    out = gmc.match_batch(g_rgbs, g_deps)
    for i, c in enumerate((cid, cid2)):
        check_golden(gold, f"mc{i}_m_", out[c], f"prune golden two-object class {c}")
    check_golden(gold, "mc_pp_", gmc.last_prune, "prune golden two-object PrunePlan")
    valid["two_object"] = [int(out[c].valid.sum()) for c in (cid, cid2)]
    emit("prune_golden", frames=gB, templates=bank.num_templates, equal=True,
         valid_matches=valid)
    del gmc, gd

    # -- B=32 over the tiled bank: the pooled matcher on the same batch -------
    rgbs, deps = two["rgbs"], two["deps"]
    pm = BatchedMatcher(det, cid, thr, B_MAIN, device=dev, **slice_settings(B_MAIN))
    m_pool = pm.match_batch(rgbs, deps)  # warm-up too
    pooled_ms = event_times(lambda: pm.match_batch(rgbs, deps))
    want = valid_set(m_pool)
    require(want.total() > 0, "the mixed batch has no valid match at the threshold")
    del pm

    def golden_rows(record, prefix, what):
        # A frame's survivors do not depend on the batch's other frames,
        # nor on the bank's tiling (the copies tie, dead rows never win).
        for name in ("p_idx", "p_keep", "m_survivors"):
            require(np.array_equal(getattr(record, name)[-gB:].cpu().numpy(),
                                   gold[prefix + name]),
                    f"{what}: {name} of the golden frames differs from the reference")

    launches_pos, rows = None, {}
    for key, kw in settings.items():
        m = BatchedMatcher(det, cid, thr, B_MAIN, top_k=top_k, prune=True, device=dev, **kw)
        m.match_batch(rgbs, deps)  # warm-up
        torch.cuda.synchronize()
        tracing.reset()
        got = m.match_batch(rgbs, deps)
        torch.cuda.synchronize()
        launches = tracing.launches()
        for k in ("quantize_cg", "spread_response", "walk_scores"):
            require(launches[k] > 0, f"kernel {k} was not launched by prune mode {key}")
        pp, fp = m.last_prune, m.last_fine
        times = event_times(lambda: m.match_batch(rgbs, deps))
        m.plain = True
        plain = m.match_batch(rgbs, deps)
        require(matches_equal(got, plain), f"prune {key}: kernel path != plain path")
        require(matches_equal(pp, m.last_prune), f"prune {key}: PrunePlan kernel != plain")
        if key != "two":
            require(matches_equal(fp, m.last_fine), f"prune {key}: FinePlan kernel != plain")
            golden_rows(pp, f"{key}_pp_", f"prune {key} PrunePlan")
            golden_rows(fp, f"{key}_fp_", f"prune {key} FinePlan")
            require(bool(pp.overflow) == (key == "cof") and
                    bool(fp.overflow) == (key == "fof"),
                    f"prune {key}: overflow flags {bool(pp.overflow)}, {bool(fp.overflow)}")
        if key == "two" and bool(pp.overflow):  # no fallback: a subset, and the flag
            require(valid_set(got) <= want, "two_axis: a valid match the pooled path lacks")
        else:
            require(valid_set(got) == want,
                    f"prune {key}: valid matches != the pooled matcher's")
        if key == "pos":
            launches_pos = launches
        rows[key] = dict(
            settings=kw, launches=launches, batch_ms=times,
            valid_matches=int(got.valid.sum()), coarse_overflow=bool(pp.overflow),
            coarse_survivors=int(pp.m_survivors.sum()),
            coarse_survivors_max=int(pp.m_survivors.max()),
            fine_overflow=None if fp is None else bool(fp.overflow),
            fine_survivors=None if fp is None else int(fp.m_survivors.sum()),
            template_survivors=int(pp.n_survivors),
            valid_of_pooled=f"{int(got.valid.sum())}/{want.total()}")
        del m
    emit("prune_modes_batch", batch=B_MAIN, templates=det.bank(cid).num_templates,
         threshold=thr, top_k=top_k, equal_kernel_vs_plain=True,
         valid_equal_pooled=True, golden_frame_rows_equal=True,
         pooled_batch_ms=pooled_ms, modes=rows,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)

    # -- the default-mode two-object matcher against phase 8's pooled result --
    td, cids = two["detector"], two["class_ids"]
    mc = MultiClassBatchedMatcher(td, list(cids), two["thresholds"], B_MAIN,
                                  top_k=two["top_k"], device=dev)
    mc.match_batch(rgbs, deps)  # warm-up
    torch.cuda.synchronize()
    tracing.reset()
    got = mc.match_batch(rgbs, deps)
    torch.cuda.synchronize()
    launches = tracing.launches()
    for k in ("quantize_cg", "spread_response", "walk_scores"):
        require(launches[k] > 0, f"kernel {k} was not launched by the two-object matcher")
    pp = mc.last_prune
    times = event_times(lambda: mc.match_batch(rgbs, deps))
    mc.plain = True
    plain = mc.match_batch(rgbs, deps)
    for c in cids:
        require(matches_equal(got[c], plain[c]),
                f"two-object positions {c}: kernel path != plain path")
        require(valid_set(got[c]) == valid_set(two["pooled"][c]),
                f"two-object positions {c}: valid matches != the pooled mode's")
    require(matches_equal(pp, mc.last_prune), "two-object PrunePlan: kernel != plain")
    golden_rows(pp, "mc_pp_", "two-object PrunePlan")
    emit("two_object_positions", batch=B_MAIN, templates=int(mc.feats1.count.numel()),
         equal_kernel_vs_plain=True, valid_equal_pooled=True, launches=launches,
         overflow=bool(pp.overflow), coarse_survivors=int(pp.m_survivors.sum()),
         valid_matches=[int(got[c].valid.sum()) for c in cids], batch_ms=times,
         pooled_batch_ms=two["pooled_ms"],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    del mc, td

    # -- the RGB-only bank (one modality, C = 8) through the pooled path ------
    rd = Detector.read(RGB_BANK, device=dev)
    rcid = rd.class_ids[0]
    rbank = rd.bank(rcid)
    require(rbank.num_modalities == 1 and not rd.params.use_depth_normal,
            "the RGB-only bank has a second modality")
    rd.attach_bank(rbank.tile(-(-10240 // rbank.num_templates), TILE_TO))
    # Colour alone scores lower on these scenes than RGB-D does and its
    # bound prunes less: at 80 the batch holds 2033 coarse survivors, past
    # slice_settings' 56 B pool, so the pools are 96 B and 64 B here.
    rthr = 80.0
    rm = BatchedMatcher(rd, rcid, rthr, B_MAIN, device=dev,
                        **{**slice_settings(B_MAIN), "pool_coarse": 96 * B_MAIN,
                           "pool_fine": 64 * B_MAIN})
    rm.match_batch(rgbs)  # warm-up
    torch.cuda.synchronize()
    tracing.reset()
    R0, cands, n_valid = rm.candidates(rgbs)
    got = rm.refine(R0, cands, n_valid)
    torch.cuda.synchronize()
    launches = tracing.launches()
    require((launches["quantize_cg"], launches["spread_response"],
             launches["walk_scores"]) == (2, 2, 1),
            f"RGB-only bank: launches {launches}, expected K1 x2, K2 x2, K3 x1")
    require(R0.shape[1] == 8, f"RGB-only bank: {R0.shape[1]} response channels")
    stats = rm.last_pool
    require(not bool(stats.fallback), "the RGB-only batch fell back; it must "
            "exercise the pooled branch")
    times = event_times(lambda: rm.match_batch(rgbs))
    rm.plain = True
    require(matches_equal(got, rm.match_batch(rgbs)),
            "RGB-only bank: kernel path != plain path")
    emit("rgb_only_pooled", batch=B_MAIN, templates=rd.bank(rcid).num_templates,
         threshold=rthr, channels=8, equal_kernel_vs_plain=True, launches=launches,
         stats={k: v.tolist() for k, v in stats._asdict().items()},
         valid_matches=int(got.valid.sum()), batch_ms=times)
    return launches_pos


def transform_err(translation, rotation_xyzw, T) -> tuple[float, float]:
    """(degrees, mm) between a wire Transform and a (4, 4) pose."""
    from linemod_pose_estimation_tpu_torch.api import transforms as TR

    x, y, z, w = rotation_xyzw
    return pose_err(TR.make_affine(*translation, w, x, y, z), T)


def run_cli(args, stdin=None, timeout=300) -> list:
    """`python -m linemod_pose_estimation_tpu_torch ...` on the card; its
    JSON lines."""
    proc = subprocess.run([sys.executable, "-m", "linemod_pose_estimation_tpu_torch", *args],
                          input=stdin, capture_output=True, text=True, timeout=timeout,
                          cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
    require(proc.returncode == 0, f"CLI {args[0]} exited {proc.returncode}:\n"
            f"{proc.stderr[-3000:]}")
    return [json.loads(line) for line in proc.stdout.strip().splitlines()]


def load_stream_tool():
    import importlib.util

    spec = importlib.util.spec_from_file_location("bench_streaming_torch", STREAM_TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def serving_phase(dev: torch.device, perf: dict) -> tuple[dict, dict]:
    """Phase 11 (the serving surface, the streaming step, the streaming
    tool); adds K4's row at template_refinement's launch to `perf` and
    returns the launch counts of one service request and of one
    streaming step."""
    import shutil

    from linemod_pose_estimation_tpu_torch.api import transforms as TR
    from linemod_pose_estimation_tpu_torch.api.nodes import (PollingMultiObjectDetector,
                                                             StreamingDetector,
                                                             save_replay_frame)
    from linemod_pose_estimation_tpu_torch.api.service import Frame, ObjectConfig, PoseService
    from linemod_pose_estimation_tpu_torch.models.pipeline import DetectionPipeline
    from linemod_pose_estimation_tpu_torch.models.serving import (
        BatchedMatcher, PipelinedRunner, look_at_point, slice_settings, template_refinement)
    from linemod_pose_estimation_tpu_torch.models.templates import TemplateBank
    from linemod_pose_estimation_tpu_torch.ops import raster as RA
    from linemod_pose_estimation_tpu_torch.utils import scenes as S
    from linemod_pose_estimation_tpu_torch.utils import tracing
    from linemod_pose_estimation_tpu_torch.utils.stl import save_binary_stl

    with np.load(SERVING_GOLDEN) as z:
        g = {k: z[k] for k in z.files}
    with np.load(CASCADE_GOLDEN) as z:
        rgbs = z["rgb"]
        depths = z["depth_mm"]
    meta, glob = TemplateBank.read_params_yaml(RGB_PARAMS)
    clouds = S.replay_clouds(depths, glob.focal_length_x, glob.focal_length_y)
    frames = [Frame(rgb=r, cloud=c) for r, c in zip(rgbs, clouds)]
    thr, nf = float(g["threshold"]), len(frames)
    pipe = DetectionPipeline.from_files(RGB_BANK, RGB_PARAMS, S.cuboid_mesh(), device=dev)
    identity = (TR.Transform.identity().translation, TR.Transform.identity().rotation)

    def within(e, what):
        require(e[0] <= POSE_TOL[0] and e[1] <= POSE_TOL[1], f"{what}: off the reference by {e}")
        return dict(deg=e[0], mm=e[1])

    def check_dets(dets, f, what):
        n = int(g["det_n"][f])
        require([d.rect for d in dets] == [tuple(int(v) for v in r) for r in g["det_rect"][f][:n]],
                f"{what} frame {f}: rects {[d.rect for d in dets]} differ from the reference")
        return [within(pose_err(d.pose, g["det_pose"][f][i]), f"{what} frame {f} det {i}")
                for i, d in enumerate(dets)]

    # -- the service: four requests, one a frame ------------------------------
    cur = {"f": 0}
    svc = PoseService(lambda: frames[cur["f"]], base_tool0_source=lambda: g["base_tool0"])
    svc.register_object(0, ObjectConfig(pipeline=pipe, threshold=thr))
    svc.linemod_object_pose(0)  # warm-up
    torch.cuda.synchronize()
    tracing.reset()
    answers = []
    for f in range(nf):
        cur["f"] = f
        answers.append(svc.linemod_object_pose(0))
    torch.cuda.synchronize()
    launches = tracing.launches()
    for k in ("quantize_cg", "spread_response", "walk_scores", "raster_zbuffer"):
        require(launches[k] > 0, f"kernel {k} was not launched by the service")
    errs = []
    for f, t in enumerate(answers):
        if g["det_n"][f] == 0:
            require((t.translation, t.rotation) == identity,
                    f"service frame {f}: a miss must give the identity, got {t}")
            errs.append("identity")
            continue
        T = TR.make_affine(*g["svc_translation"][f], g["svc_rotation"][f][3],
                           *g["svc_rotation"][f][:3])
        errs.append(within(transform_err(t.translation, t.rotation, T), f"service frame {f}"))
    unknown = svc.linemod_object_pose(int(g["unknown_id"]))
    require((unknown.translation, unknown.rotation) == identity,
            f"service: an unknown object id must give the identity, got {unknown}")
    cur["f"] = 0
    tracing.reset()
    svc.linemod_object_pose(0)
    torch.cuda.synchronize()
    per_request = tracing.launches()
    request_ms = timed(lambda: svc.linemod_object_pose(0), 5)

    # -- the detections, the nodes, look_at_point, template_refinement -------
    det_errs, look, refined = [], [], []
    stream = StreamingDetector(pipe, threshold=thr)
    ticks = iter(frames)
    poll = PollingMultiObjectDetector(lambda: next(ticks))
    poll.register_object(0, ObjectConfig(pipeline=pipe, threshold=thr))
    renders, first_refinement = [], None
    for f, fr in enumerate(frames):
        dets = pipe.detect(fr.rgb, fr.cloud, thr)
        det_errs.append(check_dets(dets, f, "detect"))
        best = stream.feed(fr)  # the node publishes the best detection only
        require((best is None) == (g["det_n"][f] == 0), f"StreamingDetector frame {f}: {best}")
        if best is not None:
            require(best.rect == tuple(int(v) for v in g["det_rect"][f][0]),
                    f"StreamingDetector frame {f}: rect {best.rect}")
            within(pose_err(best.pose, g["det_pose"][f][0]), f"StreamingDetector frame {f}")
        oid, pdets = poll.run_once()
        require(oid == 0, f"PollingMultiObjectDetector ticked object {oid}")
        check_dets(pdets, f, "PollingMultiObjectDetector")
        cloud = torch.from_numpy(fr.cloud).to(dev)
        for i in range(int(g["det_n"][f])):
            rect = tuple(int(v) for v in g["det_rect"][f][i])
            p = look_at_point(cloud, rect).cpu().numpy()
            require(np.array_equal(p, g["look_at"][f][i]),
                    f"look_at_point frame {f}: {p.tolist()} != {g['look_at'][f][i].tolist()}")
            look.append(p.tolist())
            args = (torch.from_numpy(g["det_pose"][f][i]).to(dev), cloud, rect,
                    pipe.triangles, pipe.K_render, pipe.render_wh)
            got = calls_of([(RA, "raster_zbuffer")],
                           lambda: refined.append(template_refinement(*args)))
            first_refinement = first_refinement or args
            renders += got["raster_zbuffer"]
            T, fit = refined[-1]
            e = within(pose_err(T.cpu().numpy(), g["refined_pose"][f][i]),
                       f"template_refinement frame {f}")
            e["fitness_diff"] = abs(float(fit) - float(g["refined_fitness"][f][i]))
            refined[-1] = e
    require(len(renders) == int(g["det_n"].sum()), f"template_refinement: {len(renders)} "
            f"K4 calls for {int(g['det_n'].sum())} refinements")
    coefs, w, h = renders[0]
    require(coefs.shape[0] == 1 and (w, h) == (256, 256),
            f"template_refinement's K4: {coefs.shape[0]} poses at {w}x{h}")
    perf["raster_zbuffer"]["template_refinement_captured"] = dict(
        **raster_vs_plain(coefs, w, h, "template_refinement_captured"),
        **raster_times(coefs, w, h))
    tracing.reset()
    template_refinement(*first_refinement)
    torch.cuda.synchronize()
    refine_launches = tracing.launches()
    emit("serving_golden", frames=nf, threshold=thr, bank="boxNew_full (RGB-only)",
         launches=launches, launches_per_request=per_request,
         request_ms_median_of_5=float(np.median(request_ms)), request_ms=request_ms,
         service_vs_reference=errs, unknown_id_identity=True,
         detect_vs_reference=det_errs, nodes_equal=True, look_at=look,
         template_refinement_vs_reference=refined, template_refinement_launches=refine_launches,
         K4_template_refinement=perf["raster_zbuffer"]["template_refinement_captured"],
         pose_tolerance_deg_mm=POSE_TOL)

    # -- the CLI, as subprocesses on the card ----------------------------------
    work = os.path.join(REPO, "build", "serving_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.join(work, "frames"))
    stl = os.path.join(work, "cuboid.stl")
    save_binary_stl(stl, S.cuboid_mesh().triangles)
    for f, fr in enumerate(frames):
        save_replay_frame(os.path.join(work, "frames", f"f{f}.npz"), fr.rgb, fr.cloud)
    t0 = time.perf_counter()
    recs = run_cli(["detect", RGB_BANK, RGB_PARAMS, stl, os.path.join(work, "frames"),
                    "--threshold", str(thr), "--device", "cuda"])
    detect_s = time.perf_counter() - t0
    require([r["frame"] for r in recs] == list(range(nf)), "CLI detect: frames")
    cli_errs = []
    for f, r in enumerate(recs):
        n = int(g["det_n"][f])
        require([tuple(d["rect"]) for d in r["detections"]]
                 == [tuple(int(v) for v in x) for x in g["det_rect"][f][:n]],
                 f"CLI detect frame {f}: rects differ from the reference")
        cli_errs += [within(pose_err(np.array(d["pose"]), g["det_pose"][f][i]),
                            f"CLI detect frame {f}") for i, d in enumerate(r["detections"])]
    t0 = time.perf_counter()
    lines = run_cli(["serve", os.path.join(work, "frames"), "--object",
                     f"0:{RGB_BANK}:{RGB_PARAMS}:{stl}:{thr}", "--device", "cuda"],
                    stdin="0\n" * nf + f"{int(g['unknown_id'])}\nquit\n")
    serve_s = time.perf_counter() - t0
    require(lines[0] == {"serving": [0]} and len(lines) == nf + 2, f"CLI serve: {lines[:1]}")
    ident = dict(translation=[0.0, 0.0, 0.0], rotation_xyzw=[0.0, 0.0, 0.0, 1.0])
    for f, line in enumerate(lines[1:nf + 1]):
        if g["det_n"][f] == 0:
            require(line == {"object_id": 0, **ident}, f"CLI serve frame {f}: not the identity")
            continue
        # the CLI's service has no robot: base <- tool0 is the identity
        T = TR.base_to_object(np.eye(4), g["det_pose"][f][0].astype(np.float64))
        cli_errs.append(within(transform_err(line["translation"], line["rotation_xyzw"], T),
                               f"CLI serve frame {f}"))
    require(lines[-1] == {"object_id": int(g["unknown_id"]), **ident},
            "CLI serve: an unknown object id must give the identity")
    shutil.rmtree(work, ignore_errors=True)
    emit("serving_cli", detect_frames=nf, serve_requests=nf + 1, vs_reference=cli_errs,
         detect_process_s=detect_s, serve_process_s=serve_s)

    # -- the streaming step at B=32 --------------------------------------------
    tool = load_stream_tool()
    t0 = time.perf_counter()
    st = tool.Streaming(dev)
    sframes, sdepths = tool.scenes()
    setup_s = time.perf_counter() - t0
    rd = torch.from_numpy(sframes).to(dev)
    dd = torch.from_numpy(sdepths).to(dev)
    m_kern = st.matcher.match_batch(rd, dd)
    plain = BatchedMatcher(st.det, st.cid, tool.THRESHOLD, st.batch, device=dev, plain=True,
                           **slice_settings(st.batch))
    require(matches_equal(m_kern, plain.match_batch(rd, dd)),
            "streaming step: kernel path != plain path")
    require(matches_equal(st.matcher.last_pool, plain.last_pool),
            "streaming step: PooledStats kernel != plain")
    del plain
    batches = [(np.roll(sframes, 4 * k, axis=0), np.roll(sdepths, 4 * k, axis=0))
               for k in range(8)]
    st.step(*batches[0])  # warm-up
    torch.cuda.synchronize()
    tracing.reset()
    st.step(*batches[0])
    torch.cuda.synchronize()
    per_step = tracing.launches()
    for k in ("quantize_cg", "spread_response", "walk_scores", "raster_zbuffer"):
        require(per_step[k] > 0, f"kernel {k} was not launched by the streaming step")
    blocking, block_ms = [], []
    for b in batches:
        t0 = time.perf_counter()
        blocking.append(st.step(*b))
        torch.cuda.synchronize()
        block_ms.append((time.perf_counter() - t0) * 1e3)
    run = PipelinedRunner(st.step, depth=2, device=dev)
    piped, submit_ms = [], []
    for b in batches:
        t0 = time.perf_counter()
        out = run.submit(*b)
        submit_ms.append((time.perf_counter() - t0) * 1e3)
        if out is not None:
            piped.append(out)
    piped += run.drain()
    require(len(piped) == len(blocking), "PipelinedRunner lost a result")
    pose_diff = 0.0
    for i, (a, b) in enumerate(zip(piped, blocking)):
        for name in ("valid", "pose_valid", "fallback", "best_frame"):
            require(torch.equal(getattr(a, name), getattr(b, name)),
                    f"PipelinedRunner batch {i}: {name} differs from the blocking call's")
        pose_diff = max(pose_diff, float((a.pose - b.pose).abs().max()))
    require(pose_diff <= 1e-5, f"PipelinedRunner: poses {pose_diff} off the blocking calls'")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b in batches[:3]:
            st.step(*b)
        torch.cuda.synchronize()
    dev_ms = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA) / 1e3 / 3
    p50_block = float(np.median(block_ms))
    # what the step's pageable host-to-device copy of one batch costs
    h2d_ms = timed(lambda: (torch.as_tensor(sframes).to(dev), torch.as_tensor(sdepths).to(dev)), 5)
    emit("streaming_step", batch=st.batch, templates=st.det.bank(st.cid).num_templates,
         equal_kernel_vs_plain=True, pipelined_equals_blocking=True,
         pipelined_pose_max_abs_diff=pose_diff,
         best_frames=[int(b.best_frame) for b in blocking],
         verified_poses=[int(b.pose_valid.sum()) for b in blocking],
         launches_per_step=per_step, blocking_ms=block_ms, blocking_p50_ms=p50_block,
         submit_ms=submit_ms, pipelined_p50_per_submit_ms=float(np.median(submit_ms[2:])),
         device_ms_per_step=dev_ms, busy_share=dev_ms / p50_block,
         h2d_pageable_ms_median_of_5=float(np.median(h2d_ms)),
         h2d_bytes=int(sframes.nbytes + sdepths.nbytes), setup_s=setup_s,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    del st, run, piped, blocking, rd, dd

    # -- the streaming tool: paced + saturated, then --e2e (reported) ---------
    for args in (["--secs", "10"], ["--e2e"]):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, STREAM_TOOL, *args], capture_output=True,
                              text=True, timeout=400, cwd=REPO)
        require(proc.returncode == 0, f"bench_streaming_torch {args}: exit "
                f"{proc.returncode}\n{proc.stderr[-3000:]}")
        emit("streaming_tool", args=args, process_s=time.perf_counter() - t0,
             record=json.loads(proc.stdout.strip().splitlines()[-1]))
    return per_request, per_step


def trainer_phase(dev: torch.device, perf: dict) -> dict:
    """Phase 12 (the offline trainer); adds K1's rows at the trainer's two
    shapes and K4's at one trainer chunk to `perf` and returns the launch
    counts of one chunk."""
    import gzip
    import shutil

    from linemod_pose_estimation_tpu_torch.models import trainer as TTR
    from linemod_pose_estimation_tpu_torch.models.renderer import Renderer
    from linemod_pose_estimation_tpu_torch.models.templates import DetectorParams
    from linemod_pose_estimation_tpu_torch.ops import cuda_preprocess as CP
    from linemod_pose_estimation_tpu_torch.ops import features as F
    from linemod_pose_estimation_tpu_torch.ops import raster as RA
    from linemod_pose_estimation_tpu_torch.ops import roofline as RL
    from linemod_pose_estimation_tpu_torch.utils import scenes as S
    from linemod_pose_estimation_tpu_torch.utils import tracing
    from linemod_pose_estimation_tpu_torch.utils.stl import save_binary_stl
    from linemod_pose_estimation_tpu_torch.utils.viewsphere import generate_views

    with np.load(TRAINER_GOLDEN) as z:
        g = {k: z[k] for k in z.files}
    work = os.path.join(REPO, "build", "trainer_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    stl = os.path.join(work, "cuboid.stl")
    save_binary_stl(stl, S.cuboid_mesh().triangles)
    cfg = TTR.TrainerConfig()  # the reference's defaults: 640x480, 32,400 views
    W, H, B = cfg.width, cfg.height, cfg.render_batch
    views = generate_views(cfg.view_sphere)

    # -- K4 at one trainer chunk, K1's magnitude variant at its two shapes ---
    r = Renderer(stl, W, H, cfg.focal_length_x, cfg.focal_length_y, device=dev)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    Rs, Ts = f32([v.R for v in views[:B]]), f32([v.T for v in views[:B]])
    coefs = RA.triangle_coefficients(r.triangles, Rs, Ts, r.K.expand(B, 3, 3))
    name = f"trainer_{B}x{W}x{H}"
    perf["raster_zbuffer"][name] = dict(**raster_vs_plain(coefs, W, H, name),
                                        **raster_times(coefs, W, H))
    out = r.render_batch([v.R for v in views[:B]], [v.T for v in views[:B]])
    require(np.array_equal(out.rect.cpu().numpy(), g["rects"][:B]),
            "trainer chunk: render rects differ from the reference's")
    rgb1 = torch.stack([F.pyr_down(out.rgb[..., c]) for c in range(3)], -1).contiguous()
    for name, x in ((f"trainer_level0_u8_{B}x{H}x{W}", out.rgb),
                    (f"trainer_level1_f32_{B}x{H // 2}x{W // 2}", rgb1)):
        (q, m), (qp, mp) = (CP.quantize_color_gradient_mag2(x, 10.0),
                            F.quantize_color_gradient(x, 10.0))
        require(torch.equal(q, qp) and torch.equal(m, mp),
                f"K1 mag2 {name} differs from its plain version")
        perf["quantize_cg"][name] = dict(
            max_abs_err=max(max_abs_err(q, qp), float((m - mp).abs().max())),
            set_frac=float((q > 0).float().mean()),
            **kernel_times(lambda: CP.quantize_color_gradient_mag2(x, 10.0),
                           "quantize_cg_kernel"),
            plain_ms=cuda_ms(lambda: F.quantize_color_gradient(x, 10.0), 3),
            bound=RL.quantize_cg(*x.shape[:3], x.element_size(), mag2=True)._asdict())
    gen = torch.Generator(device=dev).manual_seed(12)
    for h, w in ODD_SHAPES:
        x = torch.randint(0, 256, (2, h, w, 3), generator=gen, device=dev, dtype=torch.uint8)
        for kind, xi in (("u8", x), ("f32", x.float())):
            (q, m), (qp, mp) = (CP.quantize_color_gradient_mag2(xi, 10.0),
                                F.quantize_color_gradient(xi, 10.0))
            require(torch.equal(q, qp) and torch.equal(m, mp),
                    f"K1 mag2 {h}x{w} {kind} differs from its plain version")
    perf["quantize_cg"]["trainer_odd_shapes"] = dict(
        max_abs_err=0, shapes=[f"{h}x{w}" for h, w in ODD_SHAPES])
    dist, diff = cfg.detector.depth.distance_threshold, cfg.detector.depth.difference_threshold
    perf["depth_normal"][f"trainer_{B}x{H}x{W}"] = depth_normal_vs_plain(
        out.depth_mm, dist, diff, f"trainer {B}x{H}x{W}")
    emit("trainer_kernels_vs_plain", K4=perf["raster_zbuffer"][f"trainer_{B}x{W}x{H}"],
         K1={k: v for k, v in perf["quantize_cg"].items() if k.startswith("trainer")},
         DN=perf["depth_normal"][f"trainer_{B}x{H}x{W}"])
    del out, rgb1, coefs

    # -- both modes at full width against the golden --------------------------
    banks = {}
    for mode in ("rgb", "rgbd"):
        c = TTR.TrainerConfig(detector=DetectorParams(use_depth_normal=mode == "rgbd"))
        tyml, pyml, gyml = (os.path.join(work, f"{mode}_{k}.yml") for k in ("t", "p", "g"))
        t0 = time.perf_counter()
        det, bank = TTR.train_and_write(stl, tyml, pyml, c, max_views=int(g["views"]),
                                        device=dev)
        wall = time.perf_counter() - t0
        with open(tyml, "rb") as f:
            require(f.read() == gzip.decompress(g[f"{mode}_templates_yml_gz"].tobytes()),
                    f"trainer {mode}: the templates YAML differs from the reference's")
        with open(gyml, "wb") as f:
            f.write(gzip.decompress(g[f"{mode}_params_yml_gz"].tobytes()))
        d_err = params_match(pyml, gyml, f"trainer {mode}")
        require(np.array_equal(bank.metadata.Rect, g["rects"][g[f"{mode}_kept"]]),
                f"trainer {mode}: Rect differs from the reference's renders")
        banks[mode] = (det, bank)
        emit("trainer_golden", mode=mode, views=int(g["views"]), templates=bank.num_templates,
             templates_yaml_equal=True, params_equal=True, d_max_abs_err_m=d_err,
             wall_s=wall)

    # -- the trained bank detects its own view ---------------------------------
    det, bank = banks["rgb"]
    meta = bank.metadata
    rgb0 = r.render(meta.R[0], meta.T[0]).rgb
    res = det.match(rgb0, 88.0)[bank.class_id]
    require(len(res) >= 1 and 0 in set(res.template_id.tolist()),
            "trained bank: view 0 does not find template 0")
    sim0 = float(res.similarity[res.template_id == 0].max())
    require(sim0 >= 95.0, f"trained bank: template 0 at {sim0} on its own view")
    emit("trainer_detects_own_view", template=0, similarity=sim0,
         x=int(res.x[np.argmax(res.similarity)]), y=int(res.y[np.argmax(res.similarity)]),
         rect0=list(det.template_rect0(bank.class_id, 0)))
    del banks, det, bank

    # -- throughput: RGB-D at full width, the committed banks' view count ----
    c = TTR.TrainerConfig(detector=DetectorParams(use_depth_normal=True))
    TTR.train_from_stl(stl, c, max_views=B, device=dev)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    tracing.reset()
    plain = calls_of([(RA, "raster_zbuffer_plain"), (F, "quantize_color_gradient"),
                      (F, "quantize_depth_normal")],
                     lambda: TTR.train_from_stl(stl, c, max_views=TRAIN_VIEWS, device=dev,
                                                stats=stats))
    torch.cuda.synchronize()
    launches = tracing.launches()
    n = stats["chunks"]
    require(launches["raster_zbuffer"] == n and launches["quantize_cg"] == 2 * n
            and launches["depth_normal"] == n,
            f"trainer: {launches} over {n} chunks (want K4 x1, K1 x2, DN x1 a chunk)")
    require(not plain, f"trainer: plain versions ran on the card: {list(plain)}")
    chunk_ms = stats.pop("chunk_device_ms")
    per_chunk = {k: v // n for k, v in launches.items()}
    emit("trainer_throughput", mode="rgbd", width=W, height=H, render_batch=B,
         launches=launches, launches_per_chunk=per_chunk, plain_calls=0,
         views_per_s=stats["views"] / stats["wall_s"],
         device_ms=sum(chunk_ms), chunk_device_ms_median=float(np.median(chunk_ms)),
         chunk_device_ms_max=max(chunk_ms), peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
         **stats)

    # -- the CLI, as a subprocess on the card ----------------------------------
    tyml, pyml, gyml = (os.path.join(work, f"cli_{k}.yml") for k in ("t", "p", "g"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "linemod_pose_estimation_tpu_torch", "train", stl,
         "--templates-out", tyml, "--params-out", pyml, "--max-views", str(int(g["views"])),
         "--device", "cuda"], capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    cli_s = time.perf_counter() - t0
    require(proc.returncode == 0, f"CLI train exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    last = json.loads(lines[-1])
    kept = int(len(g["rgb_kept"]))
    require(last == {"templates": kept, "templates_yml": tyml, "params_yml": pyml},
            f"CLI train: {last}")
    require(lines[-2] == f"trained {kept} / {int(g['views'])} views", f"CLI train: {lines[-2]}")
    with open(tyml, "rb") as f:
        require(f.read() == gzip.decompress(g["rgb_templates_yml_gz"].tobytes()),
                "CLI train: the templates YAML differs from the reference's")
    with open(gyml, "wb") as f:
        f.write(gzip.decompress(g["rgb_params_yml_gz"].tobytes()))
    params_match(pyml, gyml, "CLI train")
    shutil.rmtree(work, ignore_errors=True)
    emit("trainer_cli", views=int(g["views"]), templates=kept, files_equal=True,
         process_s=cli_s)
    return per_chunk


def aux_phase(dev: torch.device) -> dict:
    """Phase 13: Detector(engine="gather") at full width against the cascade
    golden, its three coarse engines against each other, the exact
    approx select, then the grasp planner, the segmentation ops and the
    aux filters against tests/data/torch_aux_golden.npz.  Returns the
    launch counts of one gather match."""
    from linemod_pose_estimation_tpu_torch.models.detector import Detector
    from linemod_pose_estimation_tpu_torch.models.grasp import grasping_pose_region_growing
    from linemod_pose_estimation_tpu_torch.models.templates import TemplateBank
    from linemod_pose_estimation_tpu_torch.ops import filters as FL
    from linemod_pose_estimation_tpu_torch.ops import match as M
    from linemod_pose_estimation_tpu_torch.ops import segmentation as SG
    from linemod_pose_estimation_tpu_torch.utils import pointcloud as P
    from linemod_pose_estimation_tpu_torch.utils import tracing

    with np.load(CASCADE_GOLDEN) as z:
        g = {k: z[k] for k in z.files}
    with np.load(AUX_GOLDEN) as z:
        a = {k: z[k] for k in z.files}
    thr = float(g["threshold"])
    on = lambda x: torch.as_tensor(x, device=dev)

    # -- (a) the gather engine at full width ----------------------------------
    bank = TemplateBank.read_templates_yaml(BANK)
    cid = bank.class_id
    dets = {}
    for engine in ("gather", "auto"):
        dets[engine] = Detector(bank.params, device=dev, engine=engine)
        dets[engine].attach_bank(bank)
    rgbs, deps = golden_frames(dev)
    for engine, det in dets.items():
        det.match_raw(rgbs[0], thr, depth_mm=deps[0])  # warm-up
    torch.cuda.synchronize()
    tracing.reset()
    first = dets["gather"].match_raw(rgbs[0], thr, depth_mm=deps[0])[cid]
    torch.cuda.synchronize()
    launches = tracing.launches()
    for k in ("quantize_cg", "spread_response", "walk_scores"):
        require(launches[k] > 0, f"kernel {k} was not launched by the gather match")
    for f in range(rgbs.shape[0]):
        for engine, det in dets.items():
            m = first if (f, engine) == (0, "gather") else \
                det.match_raw(rgbs[f], thr, depth_mm=deps[f])[cid]
            for name, x in m._asdict().items():
                require(np.array_equal(x.cpu().numpy(), g["m_" + name][f]),
                        f"frame {f}: engine {engine} {name} differs from the golden")
    match_ms = {e: event_times(lambda d=d: d.match_raw(rgbs[0], thr, depth_mm=deps[0]), 5)
                for e, d in dets.items()}

    T1, Kc1 = bank.params.t_pyramid[1], bank.max_cell_extent(1)
    feats1 = bank.merged_features(1).to(dev)
    W_dense = bank.dense_weights(1).to(dev)
    exact_w = dets["auto"]._exact_weights(cid)
    coarse_ms = {}
    for f in range(rgbs.shape[0]):
        pyr = M.preprocess_frame(rgbs[f], deps[f], use_depth=True)
        R1 = torch.cat([pyr.grad_r1, pyr.norm_r1])
        engines = {"gather": lambda: M.coarse_scores(R1, feats1, T1, Kc1),
                   "conv": lambda: M.coarse_scores_conv(R1, W_dense, T1),
                   "gemm": lambda: M.coarse_scores_gemm(R1, exact_w, T1, Kc1)}
        raw = {e: fn() for e, fn in engines.items()}
        require(torch.equal(raw["gather"], raw["conv"]) and torch.equal(raw["gather"],
                                                                        raw["gemm"]),
                f"frame {f}: the coarse engines disagree")
        if f == 0:
            coarse_ms = {e: event_times(fn, 5) for e, fn in engines.items()}
        Hc, Wc = raw["gather"].shape[1:]
        vpos = M.position_validity(feats1.size, T1, Hc, Wc)
        approx = M.select_candidates_approx(raw["gather"], feats1.count, vpos, thr - 5.0, 512)
        exact = M.select_candidates(raw["gather"], feats1.count, vpos, thr - 5.0, 512)
        require(matches_equal(approx, exact), f"frame {f}: approx select != select")
        # The flat-index order, independently: a stable descending sort.
        sim = 100.0 * raw["gather"].float() / (4.0 * feats1.count.clamp(min=1).float())[
            :, None, None]
        order = torch.sort(-torch.where(vpos, sim, -1.0).reshape(-1), stable=True).indices[:512]
        flat = (approx.template_id.long() * Hc + approx.cell_y) * Wc + approx.cell_x
        require(torch.equal(flat, order), f"frame {f}: select order is not the flat order")
        if f == 0:
            top = approx.similarity
            n_ties = int((top[1:] == top[:-1]).sum())
    del W_dense, R1, raw
    emit("gather_engine", frames=int(rgbs.shape[0]), templates=bank.num_templates,
         matches_equal_golden=True, engines=list(dets), coarse_engines_equal=True,
         approx_select_equal=True, ties_in_frame0_select=n_ties,
         launches_per_gather_match=launches, coarse_ms=coarse_ms, match_raw_ms=match_ms,
         dense_weights_bytes=bank.num_templates * 8 * bank.num_modalities
         * bank.extent(1) ** 2, extent1=bank.extent(1), max_cell_extent1=Kc1)
    del dets, exact_w

    # -- (b) the grasp planner and the segmentation ops -----------------------
    K = on(np.array([[FX, 0, 320.0], [0, FY, 240.0], [0, 0, 1.0]], np.float32))
    cloud = P.depth_to_cloud(P.true_div(deps[0], 1000.0), K)
    pts, valid = P.extract_rect_points(cloud, g["p_rect"][0, 0], 4096)
    roi_err = float((pts.cpu() - torch.from_numpy(a["roi_pts"])).abs().max())
    require(np.array_equal(valid.cpu().numpy(), a["roi_valid"]) and roi_err <= GRASP_TOL[2],
            f"ROI cloud off the reference's by {roi_err} m")
    clouds = {"roi": (a["roi_pts"], a["roi_valid"])}
    for name in ("view00", "view45"):
        with np.load(os.path.join(REPO, "data", f"sweep_{name}_clouds.npz")) as z:
            clouds[name] = (z["scene"], z["svalid"])
    grasp = {"roi_cloud_max_abs_err_m": roi_err}
    for name, (p, v) in clouds.items():
        p, v = on(p), on(v)
        pose, region = grasping_pose_region_growing(p, v)
        sm = SG.mls_smooth(p, v)
        euclid = SG.euclidean_cluster_largest(p, v, AUX_EUCLID_TOL)
        n, c = SG.estimate_normals(on(a[f"{name}_mls"]), v, k=50)
        full = on(a[f"{name}_support"] >= 3)
        deficient = int((v & ~full).sum())
        row = dict(
            points=int(v.sum()), region=int(region.sum()),
            region_flips=int((region.cpu() != torch.from_numpy(a[f"{name}_region"])).sum()),
            euclid=int(euclid.sum()),
            euclid_flips=int((euclid.cpu() != torch.from_numpy(a[f"{name}_euclid"])).sum()),
            rank_deficient_mls_points=deficient,
            mls_max_abs_err_m=float(torch.where(full[:, None], (sm - on(a[f"{name}_mls"])).abs(),
                                                0.0).max()),
            normals_max_abs_err=float((n - on(a[f"{name}_normals"])).abs().max()),
            pose_err_deg_mm=pose_err(pose.cpu().numpy(), a[f"{name}_pose"]),
            grasp_ms=timed(lambda: grasping_pose_region_growing(p, v), 3),
            euclid_ms=timed(lambda: SG.euclidean_cluster_largest(p, v, AUX_EUCLID_TOL), 3))
        grasp[name] = row
        require(row["region_flips"] == 0 and row["euclid_flips"] == 0,
                f"{name}: region or euclidean mask differs from the reference: {row}")
        require(row["pose_err_deg_mm"][0] <= GRASP_TOL[0]
                and row["pose_err_deg_mm"][1] <= GRASP_TOL[1]
                and row["mls_max_abs_err_m"] <= GRASP_TOL[2]
                and row["normals_max_abs_err"] <= GRASP_TOL[3],
                f"{name}: grasp off the reference: {row}")
    emit("grasp_segmentation", tol_deg_mm_m_normal=GRASP_TOL, **grasp)

    # -- (c) the aux filters ----------------------------------------------------
    rng = np.random.default_rng(13)
    noise = on(rng.integers(0, 256, (480, 640, 3)).astype(np.uint8))
    imgs = list(rgbs) + [noise]
    for f, img in enumerate(imgs):
        h = FL.rgb_to_hsv_u8(img).cpu().numpy()
        want = a["hsv_sha256"][f] if f < 4 else a["hsv_noise_sha256"]
        sample = a["hsv_sample"][f] if f < 4 else a["hsv_noise_sample"]
        require(np.array_equal(h[::16, ::16], sample)
                and hashlib.sha256(h.tobytes()).digest() == want.tobytes(),
                f"image {f}: HSV differs from the reference's")
    gate = [[bool(FL.hsv_color_filter(imgs[f], on(r), *ranges)) for ranges in AUX_GATE_RANGES]
            for f, r in zip(a["gate_frame"], a["gate_rects"])]
    require(np.array_equal(gate, a["gate"]), "hsv_color_filter differs from the reference")
    frame_rect = np.array([0, 0, 640, 480])
    rects = [[FL.absolute_rectangle(1500.0 - deps[f], on(roi), 10.0).tolist()
              for roi in (g["p_rect"][f, 0], frame_rect)] for f in range(4)]
    green = noise[..., 1].float()
    rects_noise = [FL.absolute_rectangle(green, on(r), 250.0).tolist()
                   for r in a["gate_rects"][-64:]]
    require(np.array_equal(rects, a["absrect"]) and np.array_equal(rects_noise,
                                                                   a["absrect_noise"]),
            "absolute_rectangle differs from the reference")
    for i, s in enumerate(AUX_NMS_SIZES):
        for f in range(4):
            cells = np.stack([g["m_y"][f] // 8, g["m_x"][f] // 8, g["m_template_id"][f] % 4], -1)
            keep = FL.nms_distance(on(cells.astype(np.int32)), on(g["m_similarity"][f]),
                                   on(g["m_valid"][f]), s)
            require(np.array_equal(keep.cpu().numpy(), a["nms_keep"][f, i]),
                    f"frame {f}: nms_distance differs from the reference")
        keep = FL.nms_distance(on(a["nms_cells"]), on(a["nms_scores"]), on(a["nms_valid"]), s)
        require(np.array_equal(keep.cpu().numpy(), a["nms_noise_keep"][i]),
                "seeded nms_distance differs from the reference")
    emit("aux_filters", hsv_images=len(imgs), hsv_bitwise=True, gates=int(len(gate)),
         absrects=4 * 2 + len(rects_noise), nms_cases=len(AUX_NMS_SIZES) * 5, equal=True,
         hsv_ms=timed(lambda: FL.rgb_to_hsv_u8(noise), 3),
         nms_ms=timed(lambda: FL.nms_distance(on(a["nms_cells"]), on(a["nms_scores"]),
                                              on(a["nms_valid"]), 3), 3))
    return launches


# ---------------------------------------------------------------------------
# Phase 14: the multi-device layer (parallel/), in processes of its own
# ---------------------------------------------------------------------------


def _features(z, prefix: str):
    from linemod_pose_estimation_tpu_torch.ops.match import LevelFeatures

    return LevelFeatures(*(torch.from_numpy(z[prefix + f]) for f in LevelFeatures._fields))


def _host(rec) -> dict:
    return {k: v.cpu().numpy() for k, v in rec._asdict().items()}


def _counted(fn, *args):
    """fn(*args) with the launch counts set to 0 just before it and read
    just after (the launches of that call alone)."""
    from linemod_pose_estimation_tpu_torch.utils import tracing

    torch.cuda.synchronize()
    tracing.reset()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, tracing.launches()


def _event_ms(fn) -> float:
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def _step_result(step, out, launches) -> dict:
    m, met = out
    res = dict(m=_host(m), met={k: v.item() for k, v in met.items()}, launches=launches,
               collectives=dict(step.last_collectives))
    if step.last_pool is not None:
        res["pool"] = {k: v.tolist() for k, v in step.last_pool._asdict().items()}
        res["n_valid"] = step.last_n_valid.cpu().numpy()
    return res


def _dump(out_dir: str, name: str, rank: int, obj) -> None:
    import pickle

    with open(os.path.join(out_dir, f"{name}_{rank}.pkl"), "wb") as f:
        pickle.dump(obj, f)


def _parallel_gloo_rank(rank: int, world: int, inputs: str, out_dir: str) -> None:
    """Phase 14 (a) in one of 4 gloo ranks, every rank on cuda:0: the golden
    runs (2x2 pooled and positions, the row-sharded matcher, the 4-rank
    ring), each kernel path and plain path, then the B=32 pooled step over
    the tiled bank: kernel path timed, plain path, launches."""
    import torch.distributed as dist

    from linemod_pose_estimation_tpu_torch.ops import match as M
    from linemod_pose_estimation_tpu_torch.parallel import mesh as PM
    from linemod_pose_estimation_tpu_torch.parallel import sharded_match as SM
    from linemod_pose_estimation_tpu_torch.parallel.ingest import put_global_batch

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    z = np.load(inputs)
    p = json.loads(str(z["params"]))
    T0, T1, Kc1, E0, C = p["T0"], p["T1"], p["Kc1"], p["E0"], p["C"]
    kw = dict(T1=T1, Kc1=Kc1, top_k=p["top_k"], threshold=THRESHOLD, T0=T0, E0=E0,
              use_depth=True)
    mesh = PM.make_mesh(2, 2, device_type="cuda")
    d, b = mesh.get_local_rank("data"), mesh.get_local_rank("bank")
    res = {}

    g1, g0 = _features(z, "g1_"), _features(z, "g0_")
    gbank = SM.make_sharded_bank(mesh, g1, g0, C, T1, Kc1, fine_g=4, group_bound=16,
                                 device=dev)
    rg, dp = put_global_batch(mesh, z["gold_rgb"][2 * d:2 * d + 2],
                              z["gold_depth"][2 * d:2 * d + 2])
    modes = {"pool": dict(prune_mode="pooled", **p["gold_pool"]),
             "pos": dict(prune_mode="positions")}
    for key, mode in modes.items():
        for plain in (False, True):
            step = SM.make_sharded_detect_step(mesh, prune=True, plain=plain, **mode, **kw)
            out, launches = _counted(step, rg, dp, gbank)
            res[key + "_plain" * plain] = _step_result(step, out, launches)
    del gbank

    R0, R1 = M.preprocess_frames_batched(
        torch.from_numpy(z["gold_rgb"][:1]).to(dev),
        torch.from_numpy(z["gold_depth"][:1]).to(dev), T0=T0, T1=T1, use_depth=True)
    h0, h1 = R0.shape[2] // 2, R1.shape[2] // 2
    R0s = R0[0, :, b * h0:(b + 1) * h0].contiguous()
    R1s = R1[0, :, b * h1:(b + 1) * h1].contiguous()
    f1, f0 = g1.to(dev), g0.to(dev)
    W1 = M.exact_weights(f1, C, T1, Kc1)
    for plain in (False, True):
        row = SM.make_row_sharded_matcher(mesh, "bank", T1, Kc1, p["top_k"], THRESHOLD,
                                          T0=T0, E0=E0, plain=plain)
        m, launches = _counted(row, R1s, R0s, W1, f1, f0)
        res["row" + "_plain" * plain] = dict(m=_host(m), launches=launches,
                                             collectives=dict(row.last_collectives))
    del W1, f1, f0, R0, R1

    rmesh = PM.make_mesh(1, 4, device_type="cuda")
    r = rmesh.get_local_rank("bank")
    rbank = SM.make_ring_bank(rmesh, "bank", g1, g0, C, T1, Kc1, device=dev)
    for plain in (False, True):
        ring = SM.make_ring_detect_step(rmesh, "bank", plain=plain, **kw)
        m, launches = _counted(ring, z["gold_rgb"][r:r + 1], z["gold_depth"][r:r + 1], rbank)
        res["ring" + "_plain" * plain] = dict(m=_host(m), launches=launches,
                                              collectives=dict(ring.last_collectives))
    del rbank

    Bl = p["B"] // 2
    tbank = SM.make_sharded_bank(mesh, _features(z, "t1_"), _features(z, "t0_"), C, T1,
                                 Kc1, fine_g=4, group_bound=16, device=dev)
    rg, dp = put_global_batch(mesh, z["b_rgb"][Bl * d:Bl * (d + 1)],
                              z["b_depth"][Bl * d:Bl * (d + 1)])
    skw = dict(prune=True, prune_mode="pooled", pool_coarse=56 * Bl, pool_fine=36 * Bl,
               sel_row_cap=128, **kw)
    step = SM.make_sharded_detect_step(mesh, **skw)
    step(rg, dp, tbank)  # warm-up (cuBLASLt heuristics, caches)
    box = {}
    grouped = calls_of([(M, "pool_plan_grouped")],
                       lambda: box.update(run=_counted(step, rg, dp, tbank)))
    res["b32"] = _step_result(step, *box["run"])
    res["b32"]["grouped_calls"] = len(grouped.get("pool_plan_grouped", []))
    ms = []
    for _ in range(3):
        dist.barrier()
        ms.append(_event_ms(lambda: step(rg, dp, tbank)))
    res["b32"]["ms"] = ms
    plain = SM.make_sharded_detect_step(mesh, plain=True, **skw)
    out, launches = _counted(plain, rg, dp, tbank)
    res["b32_plain"] = _step_result(plain, out, launches)
    _dump(out_dir, "gloo", rank, res)


def _parallel_nccl_rank(rank: int, world: int, inputs: str, out_dir: str) -> None:
    """Phase 14 (b): the B=32 pooled step on a 1x1 mesh over NCCL."""
    import torch.distributed as dist

    from linemod_pose_estimation_tpu_torch.parallel import mesh as PM
    from linemod_pose_estimation_tpu_torch.parallel import sharded_match as SM
    from linemod_pose_estimation_tpu_torch.parallel.ingest import put_global_batch

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    z = np.load(inputs)
    p = json.loads(str(z["params"]))
    mesh = PM.make_mesh(1, 1, device_type="cuda")
    tbank = SM.make_sharded_bank(mesh, _features(z, "t1_"), _features(z, "t0_"), p["C"],
                                 p["T1"], p["Kc1"], fine_g=4, group_bound=16, device=dev)
    rg, dp = put_global_batch(mesh, z["b_rgb"], z["b_depth"])
    B = p["B"]
    step = SM.make_sharded_detect_step(
        mesh, p["T1"], p["Kc1"], p["top_k"], THRESHOLD, T0=p["T0"], E0=p["E0"],
        use_depth=True, prune=True, prune_mode="pooled", pool_coarse=56 * B,
        pool_fine=36 * B, sel_row_cap=128)
    step(rg, dp, tbank)  # warm-up
    res = _step_result(step, *_counted(step, rg, dp, tbank))
    res["ms"] = [_event_ms(lambda: step(rg, dp, tbank)) for _ in range(3)]
    res["backend"] = str(dist.get_backend())
    _dump(out_dir, "nccl", rank, res)


def _nccl_duplicate_rank(rank: int, world: int, out_dir: str) -> None:
    """Two NCCL ranks on cuda:0: what NCCL says to a second rank on one
    GPU."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    t = torch.ones(1, device="cuda")
    try:
        dist.all_reduce(t)
        torch.cuda.synchronize()
        said = None
    except dist.DistBackendError as e:
        said = str(e)
    _dump(out_dir, "nccl_duplicate", rank, said)


def _load_ranks(out_dir: str, name: str, world: int) -> list:
    import pickle

    out = []
    for r in range(world):
        path = os.path.join(out_dir, f"{name}_{r}.pkl")
        require(os.path.exists(path), f"phase 14: rank {r} wrote no {name} result")
        with open(path, "rb") as f:
            out.append(pickle.load(f))
    return out


def _valid_multiset(m: dict, b: int) -> collections.Counter:
    return collections.Counter(
        (int(t), int(x), int(y), float(s)) for t, x, y, s, v in zip(
            m["template_id"][b], m["x"][b], m["y"][b], m["similarity"][b], m["valid"][b]) if v)


def _same(a: dict, b: dict) -> bool:
    return all(np.array_equal(a[k], b[k]) for k in a)


def parallel_phase(dev: torch.device) -> dict:
    """Phase 14: the multi-device layer in processes of its own
    (parallel.mesh.spawn).  (a) 4 gloo ranks on cuda:0 (NCCL refuses two
    ranks on one GPU; the phase shows what it says): the 2x2 detect step
    (pooled with the group tier, positions), the row-sharded matcher and
    the 4-rank ring against tests/data/torch_sharded_golden.npz, each also
    kernel path against plain path; the B=32 pooled step over the tiled
    bank on phase 8's batch, kernel against plain on every rank, best match
    and valid sets against the single-device BatchedMatcher.  (b) the same
    B=32 step on one NCCL rank.  Returns the launches of one (a) B=32 step per rank and
    of one ring step."""
    import shutil

    from linemod_pose_estimation_tpu_torch.models.detector import Detector
    from linemod_pose_estimation_tpu_torch.models.serving import BatchedMatcher, slice_settings
    from linemod_pose_estimation_tpu_torch.parallel import mesh as PM
    from linemod_pose_estimation_tpu_torch.utils import scenes as S

    work = os.path.join(REPO, "build", "phase14")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    with np.load(SHARDED_GOLDEN) as z:
        gold = {k: z[k] for k in z.files}
    with np.load(CASCADE_GOLDEN) as z:
        g_rgb, g_dep = z["rgb"], z["depth_mm"]
    det = Detector.read(BANK, device=dev)
    cid = det.class_ids[0]
    bank = det.bank(cid)
    T0, T1 = det.params.t_pyramid
    feats = lambda bk, lv: {f: a.numpy() for f, a in bk.merged_features(lv)._asdict().items()}
    arrays = {**{"g1_" + k: v for k, v in feats(bank, 1).items()},
              **{"g0_" + k: v for k, v in feats(bank, 0).items()}}
    params = dict(T0=T0, T1=T1, Kc1=bank.max_cell_extent(1), E0=bank.extent(0),
                  C=8 * bank.num_modalities, top_k=int(gold["top_k"]), B=B_MAIN,
                  gold_pool={k: int(gold[k]) for k in ("pool_coarse", "pool_fine",
                                                       "sel_row_cap")})
    tiled = bank.tile(-(-10240 // bank.num_templates), TILE_TO)
    require((tiled.max_cell_extent(1), tiled.extent(0)) == (params["Kc1"], params["E0"]),
            "the tiled bank's extents differ from the bank's")
    arrays.update({"t1_" + k: v for k, v in feats(tiled, 1).items()})
    arrays.update({"t0_" + k: v for k, v in feats(tiled, 0).items()})
    # Phase 8's batch: phase 2b's first 28 scenes, whose matches all stay
    # below 91, and the 4 cascade frames, which reach it.
    rgbs, deps, _ = S.bin_picking_batch(B_MAIN, seed=3)
    rgbs = np.concatenate([rgbs[:B_MAIN - len(g_rgb)], g_rgb])
    deps = np.concatenate([deps[:B_MAIN - len(g_dep)], g_dep])
    inputs = os.path.join(work, "inputs.npz")
    np.savez(inputs, params=json.dumps(params), gold_rgb=g_rgb, gold_depth=g_dep,
             b_rgb=rgbs, b_depth=deps, **arrays)

    det.attach_bank(tiled)
    single = BatchedMatcher(det, cid, THRESHOLD, B_MAIN, device=dev, **slice_settings(B_MAIN))
    trgb, tdep = torch.from_numpy(rgbs).to(dev), torch.from_numpy(deps).to(dev)
    single.match_batch(trgb, tdep)  # warm-up
    ref = _host(single.match_batch(trgb, tdep))
    ref_nv = single.last_n_valid.cpu().numpy()
    single_ms = [_event_ms(lambda: single.match_batch(trgb, tdep)) for _ in range(3)]
    del single, det, trgb, tdep
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    PM.spawn(_nccl_duplicate_rank, 2, "nccl", os.path.join(work, "rdv_dup"),
             args=(work,), timeout_s=90.0)
    said = _load_ranks(work, "nccl_duplicate", 2)
    require(all(s is not None and "Duplicate GPU detected" in s for s in said),
            f"phase 14: two NCCL ranks on one GPU did not fail as expected: {said}")
    dup_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    PM.spawn(_parallel_gloo_rank, 4, "gloo", os.path.join(work, "rdv_gloo"),
             args=(inputs, work), timeout_s=PARALLEL_TIMEOUT_S)
    gloo_s = time.perf_counter() - t0
    ranks = _load_ranks(work, "gloo", 4)
    for r, res in enumerate(ranks):
        d = r // 2
        for key in ("pool", "pos"):
            for name, a in res[key]["m"].items():
                require(np.array_equal(a, gold[f"{key}_m_{name}"][2 * d:2 * d + 2]),
                        f"phase 14 rank {r}: the 2x2 {key} step's {name} differs from "
                        "the golden")
            for k, v in res[key]["met"].items():
                require(v == gold[f"{key}_{k}"].item(),
                        f"phase 14 rank {r}: {key} metric {k} differs from the golden")
        for name, a in res["row"]["m"].items():
            require(np.array_equal(a, gold[f"row_m_{name}"]),
                    f"phase 14 rank {r}: the row-sharded {name} differs from the golden")
        for name, a in res["ring"]["m"].items():
            require(np.array_equal(a[0], gold[f"ring_m_{name}"][r]),
                    f"phase 14 rank {r}: the ring step's {name} differs from the golden")
        for key in ("pool", "pos", "row", "ring", "b32"):
            require(_same(res[key]["m"], res[key + "_plain"]["m"]),
                    f"phase 14 rank {r}: {key} kernel path != plain path")
            require(not any(res[key + "_plain"]["launches"].values()),
                    f"phase 14 rank {r}: {key}'s plain path launched a kernel")
        require(res["b32"]["met"] == res["b32_plain"]["met"],
                f"phase 14 rank {r}: B=32 metrics kernel != plain")
        for key in ("pool", "pos", "ring", "b32"):
            for k in ("quantize_cg", "spread_response", "walk_scores"):
                require(res[key]["launches"][k] > 0,
                        f"phase 14 rank {r}: {key} launched no {k}")
        require(res["row"]["launches"]["walk_scores"] == 1,
                f"phase 14 rank {r}: the row-sharded matcher did not walk once")
        require(res["ring"]["launches"]["walk_scores"] == 4,
                f"phase 14 rank {r}: the ring step did not walk once a shard")
        require(res["b32"]["grouped_calls"] == 1,
                f"phase 14 rank {r}: the B=32 step did not run the group pool")
        require(not res["pool"]["pool"]["fallback"] and not res["b32"]["pool"]["fallback"],
                f"phase 14 rank {r}: a pooled step fell back")
        require(_same(res["b32"]["m"], ranks[r ^ 1]["b32"]["m"]),
                f"phase 14: ranks {r} and {r ^ 1} of one data row hold other Matches")

    B, K = B_MAIN, int(gold["top_k"])
    Bl = B // 2
    sharded = {k: np.concatenate([ranks[0]["b32"]["m"][k], ranks[2]["b32"]["m"][k]])
               for k in ref}

    # A frame's coarse candidates fill top_k on a side (n_valid == top_k):
    # there the single device walks its global top_k, each shard its own,
    # and the sharded step may walk (and keep) valid matches the single
    # device never reached, so the valid sets are compared elsewhere only.
    shard_nv = np.stack([np.concatenate([ranks[0 + c]["b32"]["n_valid"],
                                         ranks[2 + c]["b32"]["n_valid"]]) for c in (0, 1)])
    filled = (ref_nv == K) | (shard_nv == K).any(axis=0)

    def compare(a: dict, b: dict, what: str, all_frames: bool) -> int:
        """Best similarity per frame equal; valid multisets equal on every
        frame (all_frames) or where no side filled top_k.  Returns the
        frames whose sets were compared."""
        n = 0
        for f in range(B):
            best = lambda m: float(np.where(m["valid"][f], m["similarity"][f], -1.0).max())
            require(best(a) == best(b), f"phase 14: frame {f}'s best match, {what}")
            if all_frames or not filled[f]:
                require(_valid_multiset(a, f) == _valid_multiset(b, f),
                        f"phase 14: frame {f}'s valid matches, {what}")
                n += 1
        return n

    n_single = compare(sharded, ref, "2x2 sharded vs single-device", False)
    require(int(ref["valid"].sum()) > 0, "phase 14: the B=32 batch has no valid match")

    t0 = time.perf_counter()
    PM.spawn(_parallel_nccl_rank, 1, "nccl", os.path.join(work, "rdv_nccl"),
             args=(inputs, work), timeout_s=PARALLEL_TIMEOUT_S)
    nccl_s = time.perf_counter() - t0
    (one,) = _load_ranks(work, "nccl", 1)
    require(one["backend"] == "nccl", "phase 14 (b) did not run over NCCL")
    compare(one["m"], ref, "1x1 NCCL vs single-device", True)
    n_nccl = compare(one["m"], sharded, "1x1 NCCL vs 2x2 gloo", False)
    for k in ("quantize_cg", "spread_response", "walk_scores"):
        require(one["launches"][k] > 0, f"phase 14 (b) launched no {k}")

    per_rank = [res["b32"]["launches"] for res in ranks]
    emit("parallel", card_note="(a) is four ranks sharing one card, not a scale-out figure",
         nccl_duplicate=said[0], nccl_duplicate_s=dup_s,
         golden_equal=["pool", "pos", "row", "ring"], kernel_vs_plain_equal=True,
         b32=dict(frames=B, frames_per_rank=Bl, templates=TILE_TO,
                  templates_per_shard=TILE_TO // 2, launches_per_rank=per_rank,
                  prune_fallback_shards=ranks[0]["b32"]["met"]["prune_fallback_shards"],
                  num_matches=ranks[0]["b32"]["met"]["num_matches"],
                  pooled_stats=[res["b32"]["pool"] for res in ranks],
                  group_pool_calls=[res["b32"]["grouped_calls"] for res in ranks],
                  step_ms_per_rank=[res["b32"]["ms"] for res in ranks],
                  collective_bytes_per_rank=[res["b32"]["collectives"] for res in ranks],
                  frames_vs_single_compared=n_single,
                  frames_filled=np.flatnonzero(filled).tolist(),
                  valid_sharded=int(sharded["valid"].sum()),
                  valid_single=int(ref["valid"].sum())),
         ring=dict(launches_per_rank=[res["ring"]["launches"] for res in ranks],
                   collective_bytes_per_rank=[res["ring"]["collectives"] for res in ranks]),
         row=dict(collective_bytes_per_rank=[res["row"]["collectives"] for res in ranks]),
         golden_collective_bytes=[res["pool"]["collectives"] for res in ranks],
         nccl_1x1=dict(step_ms=one["ms"], launches=one["launches"], pooled_stats=one["pool"],
                       collective_bytes=one["collectives"],
                       frames_vs_gloo_compared=n_nccl),
         single_device_ms=single_ms, spawn_s=dict(gloo=gloo_s, nccl=nccl_s))
    return dict(per_rank=per_rank[0], ring=ranks[0]["ring"]["launches"])


def params_match(path: str, golden: str, what: str) -> float:
    """A renderer_params.yml against the reference's: R, T, K, Ori_dist,
    Rect and the globals equal, D within D_TOL; returns D's largest
    difference (m)."""
    from linemod_pose_estimation_tpu_torch.models.templates import TemplateBank

    (pm, pg), (gm, gg) = TemplateBank.read_params_yaml(path), TemplateBank.read_params_yaml(golden)
    for k in ("R", "T", "K", "Ori_dist", "Rect"):
        require(np.array_equal(getattr(pm, k), getattr(gm, k)), f"{what}: params {k} differ")
    require(pg == gg, f"{what}: the renderer globals differ")
    err = float(np.abs(pm.D - gm.D).max()) if len(pm.D) else 0.0
    require(err <= D_TOL, f"{what}: D off the reference by {err} m")
    return err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from linemod_pose_estimation_tpu_torch.models.detector import Detector
    from linemod_pose_estimation_tpu_torch.models.serving import (
        BatchedMatcher, slice_settings)
    from linemod_pose_estimation_tpu_torch.ops import _build
    from linemod_pose_estimation_tpu_torch.ops import cuda_kernels as CK
    from linemod_pose_estimation_tpu_torch.ops import cuda_preprocess as CP
    from linemod_pose_estimation_tpu_torch.ops import features as F
    from linemod_pose_estimation_tpu_torch.ops import match as M
    from linemod_pose_estimation_tpu_torch.ops import roofline as RL
    from linemod_pose_estimation_tpu_torch.utils import kernel_cases as KC
    from linemod_pose_estimation_tpu_torch.utils import scenes as S
    from linemod_pose_estimation_tpu_torch.utils import tracing

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.library()
    emit("build", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         build_s=time.perf_counter() - t0)
    perf = {k: {} for k in KERNELS}
    if sys.argv[1:] == ["--only", "options"]:
        options_phase(dev, perf)
        print(card, flush=True)
        return 0
    if sys.argv[1:] == ["--only", "serving"]:
        serving_phase(dev, perf)
        print(card, flush=True)
        return 0
    if sys.argv[1:] == ["--only", "trainer"]:
        trainer_phase(dev, perf)
        print(card, flush=True)
        return 0
    if sys.argv[1:] == ["--only", "aux"]:
        aux_phase(dev)
        print(card, flush=True)
        return 0
    if sys.argv[1:] == ["--only", "parallel"]:
        parallel_phase(dev)
        print(card, flush=True)
        return 0
    if sys.argv[1:] == ["--only", "exact"]:
        exact_phase(dev, perf)
        print(card, flush=True)
        return 0
    if sys.argv[1:] == ["--only", "select"]:
        select_phase(dev, perf)
        print(card, flush=True)
        return 0
    if sys.argv[1:] == ["--only", "bounds"]:
        bounds_phase(dev, perf)
        print(card, flush=True)
        return 0
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}", file=sys.stderr)
        return 2

    # -- phase 1: K1, K2 vs plain at the main path's shapes ------------------
    rgbs_np, deps_np, truths = S.bin_picking_batch(B_MAIN, seed=3)
    rgbs = torch.from_numpy(rgbs_np).to(dev)
    deps = torch.from_numpy(deps_np).to(dev)
    noise = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, size=rgbs_np.shape, dtype=np.uint8)).to(dev)
    level1 = lambda x: torch.stack(
        [F.pyr_down(x[..., c].float()) for c in range(3)], -1).contiguous()
    rgb1 = level1(rgbs)
    for name, x in (("level0_u8_480x640", rgbs), ("level1_f32_240x320", rgb1),
                    ("noise_level0", noise), ("noise_level1", level1(noise))):
        q = CP.quantize_color_gradient(x, 10.0)
        err = max_abs_err(q, CP.quantize_color_gradient_plain(x, 10.0))
        require(err == 0, f"K1 {name} differs from its plain version")
        perf["quantize_cg"][name] = dict(max_abs_err=err,
                                         set_frac=float((q > 0).float().mean()))
        if not name.startswith("noise"):  # time the scene batch
            perf["quantize_cg"][name].update(
                **kernel_times(lambda: CP.quantize_color_gradient(x, 10.0),
                                 "quantize_cg_kernel"),
                plain_ms=cuda_ms(lambda: CP.quantize_color_gradient_plain(x, 10.0), 3))
    for name, x in (("level0_u8_480x640", rgbs), ("level1_f32_240x320", rgb1)):
        perf["quantize_cg"][name]["bound"] = RL.quantize_cg(*x.shape[:3],
                                                            x.element_size())._asdict()
    q0 = CP.quantize_color_gradient(rgbs, 10.0)
    q1 = CP.quantize_color_gradient(rgb1, 10.0)
    perf["depth_normal"]["batch_32x480x640"] = depth_normal_vs_plain(
        deps, 2000.0, 50.0, "batch 32x480x640")
    dn_cases = KC.depth_normal_cases(dev)
    for name, (d, dist, diff) in dn_cases.items():
        err = max_abs_err(CP.quantize_depth_normal(d, dist, diff),
                          CP.quantize_depth_normal_plain(d, dist, diff))
        require(err == 0, f"DN {name} differs from its plain version")
    perf["depth_normal"]["odd_cases"] = dict(max_abs_err=0, cases=list(dn_cases))
    n0 = CP.quantize_depth_normal(deps)
    for name, q, T in (("grad_T5_480x640", q0, 5), ("grad_T8_240x320", q1, 8),
                       ("norm_T5_480x640", n0, 5),
                       ("norm_T8_240x320", n0[:, ::2, ::2].contiguous(), 8)):
        got, ref = CK.spread_response(q, T), CK.spread_response_plain(q, T)
        err = max_abs_err(got, ref)
        require(err == 0, f"K2 {name} differs from its plain version")
        perf["spread_response"][name] = dict(
            **kernel_times(lambda: CK.spread_response(q, T), "spread_response_kernel"),
            plain_ms=cuda_ms(lambda: CK.spread_response_plain(q, T), 3),
            max_abs_err=err, bound=RL.spread_response(*q.shape, T)._asdict())
    odd = odd_shapes(dev)
    perf["quantize_cg"]["odd_shapes"] = dict(max_abs_err=0, shapes=odd)
    perf["spread_response"]["odd_shapes"] = dict(max_abs_err=0, shapes=odd)
    emit("kernels_vs_plain", K1=perf["quantize_cg"], K2=perf["spread_response"],
         DN=perf["depth_normal"])

    # -- phase 2a: untiled bank, golden batch vs the JAX reference -----------
    det = Detector.read(BANK)
    cid = det.class_ids[0]
    with np.load(GOLDEN) as z:
        gold = {k: z[k] for k in z.files}
    g_rgbs, g_deps, _ = S.golden_batch(int(gold["seed"]))
    gB = g_rgbs.shape[0]
    gm = BatchedMatcher(det, cid, float(gold["threshold"]), gB, device=dev,
                        **slice_settings(gB))
    R0, cands, n_valid = gm.candidates(g_rgbs, g_deps)
    got = gm.refine(R0, cands, n_valid)
    R0g, R1g = M.preprocess_frames_batched(
        torch.from_numpy(g_rgbs).to(dev), torch.from_numpy(g_deps).to(dev),
        use_depth=True)
    require(torch.equal(R0g, R0), "preprocess is not deterministic")
    for b in range(gB):
        for R, key in ((R0g, "r0_sha256"), (R1g, "r1_sha256")):
            h = hashlib.sha256(R[b].cpu().numpy().tobytes()).hexdigest()
            require(h == str(gold[key][b]), f"{key} of frame {b} differs from the reference")
    for name in got._fields:
        require(np.array_equal(getattr(got, name).cpu().numpy(), gold[name]),
                f"golden Matches.{name} differs from the reference")
    require(np.array_equal(n_valid.cpu().numpy(), gold["n_valid"]), "golden n_valid differs")
    for name in gm.last_pool._fields:
        require(np.array_equal(getattr(gm.last_pool, name).cpu().numpy(),
                               gold["stats_" + name]), f"golden PooledStats.{name} differs")
    emit("golden_vs_reference", frames=gB, templates=det.bank(cid).num_templates,
         equal=True, n_valid=n_valid.tolist(), valid_matches=int(got.valid.sum()),
         fallback=bool(gm.last_pool.fallback))

    # -- phase 2b: B=32 over the tiled bank, kernels vs plain ---------------
    bank = det.bank(cid)
    reps = -(-10240 // bank.num_templates)
    det.attach_bank(bank.tile(reps, TILE_TO))
    kw = slice_settings(B_MAIN)
    t0 = time.perf_counter()
    main_m = BatchedMatcher(det, cid, THRESHOLD, B_MAIN, device=dev, **kw)
    plain_m = BatchedMatcher(det, cid, THRESHOLD, B_MAIN, device=dev, plain=True, **kw)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    main_m.match_batch(rgbs, deps)  # warm-up (cuBLASLt heuristics, caches)
    torch.cuda.synchronize()
    tracing.reset()
    t0 = time.perf_counter()
    m_kern = main_m.match_batch(rgbs, deps)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    launches = tracing.launches()
    for k in ("quantize_cg", "spread_response", "walk_scores"):  # this path's kernels
        require(launches[k] > 0, f"kernel {k} was not launched on the main path")
    require(launches["depth_normal"] == 1, "DN did not launch once in the main-path batch")
    require(launches["exact_scores"] == 1, "XS did not launch once in the main-path batch")
    require(launches["bound_margins"] == 3,
            "BM did not launch three times (group, cell, fine) in the main-path batch")
    require(main_m.weights.exact.dense is None,
            "the main-path matcher holds a dense one-hot operand on the card")
    stats = main_m.last_pool
    require(not bool(stats.fallback), "the main-path batch fell back; it must "
            "exercise the pooled branch")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        main_m.match_batch(rgbs, deps)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    tracing.reset()
    t0 = time.perf_counter()
    m_plain = plain_m.match_batch(rgbs, deps)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    require(not any(tracing.launches().values()), "tiled batch: the plain path launched "
            f"a kernel: {tracing.launches()}")
    require(matches_equal(m_kern, m_plain), "tiled batch: kernel path != plain path")
    found, total = S.found_rate(m_kern.valid.cpu(), m_kern.x.cpu(), m_kern.y.cpu(), truths)
    emit("tiled_batch", batch=B_MAIN, templates=det.bank(cid).num_templates,
         equal_kernel_vs_plain=True, launches=launches,
         stats={k: v.tolist() for k, v in stats._asdict().items()},
         found=f"{found}/{total}", valid_matches=int(m_kern.valid.sum()),
         batch_ms=batch_s * 1e3, batch_ms_repeats=[t * 1e3 for t in times],
         plain_batch_ms=plain_s * 1e3, setup_s=setup_s,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)

    # -- phase 2c: forced exhaustive fallback --------------------------------
    # Exactness holds for the VALID candidates and matches; the
    # sub-threshold filler slots come from different score sets.
    fb = BatchedMatcher(det, cid, THRESHOLD, B_MAIN, device=dev,
                        **{**kw, "pool_coarse": 8})
    tracing.reset()
    t0 = time.perf_counter()
    R0, c_fb, nv_fb = fb.candidates(rgbs, deps)
    m_fb = fb.refine(R0, c_fb, nv_fb)
    torch.cuda.synchronize()
    fb_s = time.perf_counter() - t0
    launches_fb = tracing.launches()
    require(bool(fb.last_pool.fallback), "forced tiny pool did not fall back")
    require(launches_fb["exact_scores"] == 1 and launches_fb["select_topk"] == 1,
            f"the fallback batch did not launch XS and TK once each: {launches_fb}")
    require(launches_fb["bound_margins"] == 2,
            f"the fallback batch did not launch BM for its group and cell tiers: {launches_fb}")
    _, c_pool, nv_pool = main_m.candidates(rgbs, deps)
    require(torch.equal(nv_fb, nv_pool), "fallback n_valid != pooled n_valid")
    require(valid_equal(c_fb, c_pool), "fallback candidates != pooled candidates")
    require(valid_equal(m_fb, m_kern), "fallback matches != pooled matches")
    emit("forced_fallback", fallback=True, equal_valid_candidates=True,
         n_valid=nv_fb.tolist(), equal_valid_matches=True, batch_ms=fb_s * 1e3,
         launches=launches_fb)

    # -- phase 2d: XS vs its plain twin and the int8 GEMM route --------------
    exact_phase(dev, perf, main_m, rgbs, deps)

    # -- phase 2e: TK vs its plain twin at the fullbin shape -----------------
    select_phase(dev, perf)

    # -- phase 2f: BM vs its plain twin on the batch's three launches --------
    bounds_phase(dev, perf, main_m, rgbs, deps)

    # -- phase 3: K3 vs plain on the tiled batch's candidate sets ------------
    R0, cands, n_valid = main_m.candidates(rgbs, deps)
    for name, nv in (("valid_prefix", n_valid),
                     ("all_slots", torch.full_like(n_valid, cands.valid.shape[1]))):
        plan = M.walk_plan(R0.shape, main_m.feats0, cands, main_m.T1, main_m.E0,
                           main_m.T0, n_valid=nv)
        ops = plan.operands()
        got = CK.walk_scores(R0, *ops, main_m.T0)
        ref = CK.walk_scores_plain(R0, *ops, main_m.T0)
        err = max_abs_err(got, ref)
        require(err == 0, f"K3 {name} differs from its plain version")
        perf["walk_scores"][name] = dict(
            **kernel_times(lambda: CK.walk_scores(R0, *ops, main_m.T0), "walk_scores_kernel"),
            plain_ms=cuda_ms(lambda: CK.walk_scores_plain(R0, *ops, main_m.T0), 3),
            max_abs_err=err, slots_walked=int(plan.n_valid.sum()),
            bound=walk_bound(R0, ops, main_m.T0)._asdict())
    odd = KC.walk_cases(dev)
    for name, (R0o, ops, T) in odd.items():
        err = max_abs_err(CK.walk_scores(R0o, *ops, T), CK.walk_scores_plain(R0o, *ops, T))
        require(err == 0, f"K3 {name} differs from its plain version")
    perf["walk_scores"]["odd_plans"] = dict(max_abs_err=0, plans=list(odd))
    del odd
    emit("walk_vs_plain", K3=perf["walk_scores"])

    per_detect = cascade_phases(dev, perf)
    del main_m, plain_m, fb
    launches7 = k5_phase(dev, det, bank, rgbs, deps, perf)
    launches9 = prune_phase(dev, det, bank, two_object_phase(dev, bank, rgbs, deps))
    del det
    launches10 = options_phase(dev, perf)
    launches11, launches_step = serving_phase(dev, perf)
    launches12 = trainer_phase(dev, perf)
    launches13 = aux_phase(dev)
    launches14 = parallel_phase(dev)

    # -- summary -------------------------------------------------------------
    # launches: of one B=32 pooled batch (phase 2b) for K1-K3, XS and BM, of one detect
    # (phase 6) for K2b and K4, of one K5 chain (phase 7) for K5, of one B=32
    # fallback batch (phase 2c) for TK.  ms, plain
    # and bound: summed over the shapes of those launches; the other timed
    # shapes (K3 over all slots and at detect's B=1, K4 at 8 poses, on the
    # 640x480 frame, on detect's own operands and on the accuracy detect's 16
    # lanes; K1's magnitude variant and K4 at the trainer's chunk) are rows of
    # `shapes`.
    off_path = ("all_slots", "detect_B1", "cascade_8x256x256", "frame_640x480",
                "detect_captured", "accuracy_captured", "refine_round_captured",
                "template_refinement_captured", "trainer_16x640x480",
                "trainer_level0_u8_16x480x640", "trainer_level1_f32_16x240x320",
                "trainer_16x480x640", f"every_cell_{B_MAIN}x{TILE_TO}")
    launches_of = {"spread_response_b1": (per_detect["spread_response"], "one detect"),
                   "raster_zbuffer": (per_detect["raster_zbuffer"], "one detect"),
                   "refine_scores": (launches7["refine_scores"], "one K5 chain"),
                   "select_topk": (launches_fb["select_topk"], "one B=32 fallback batch")}
    summary = []
    for key, (name, src, replaces) in KERNELS.items():
        shapes = perf[key]
        main_shapes = [s for s, v in shapes.items() if "ms" in v and s not in off_path]
        n, per = launches_of[key] if key in launches_of else (
            launches[key], "one B=32 pooled batch")
        ms = sum(shapes[s]["ms"] for s in main_shapes)
        bound_ms = sum(shapes[s]["bound"]["ms"] for s in main_shapes)
        by = max(main_shapes, key=lambda s: shapes[s]["bound"]["ms"])
        library = [shapes[s].get("library_ms") for s in main_shapes]
        summary.append(dict(
            name=f"{name} {key}", route="cuda", source=src, replaces=replaces,
            launches=n, launches_per=per,
            max_abs_err=max(v["max_abs_err"] for v in shapes.values()),
            ms=ms, plain_ms=sum(shapes[s]["plain_ms"] for s in main_shapes),
            bound_ms=bound_ms, bound_by=shapes[by]["bound"]["by"],
            share_of_bound=bound_ms / ms,
            library_ms=None if None in library else sum(library),
            library_note=LIBRARY_NOTES.get(key, "no single PyTorch call computes it"),
            launches_per_detect=per_detect.get(key.removesuffix("_b1")),
            launches_per_positions_batch=launches9.get(key),
            launches_per_accuracy_detect=launches10.get(key.removesuffix("_b1")),
            launches_per_serving_request=launches11.get(key.removesuffix("_b1")),
            launches_per_streaming_step=launches_step.get(key.removesuffix("_b1")),
            launches_per_trainer_chunk=launches12.get(key.removesuffix("_b1")),
            launches_per_gather_match=launches13.get(key.removesuffix("_b1")),
            launches_per_sharded_step_rank=launches14["per_rank"].get(key),
            launches_per_ring_step_rank=launches14["ring"].get(key),
            shapes=shapes))
    print(json.dumps({"kernels": summary}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
