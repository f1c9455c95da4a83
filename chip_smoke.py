"""Smoke run of the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Drives Detector.read -> BatchedMatcher(prune_mode="pooled") -> Matches
(and every other ported path: phases 6-12) on the committed RGB-D bank at
full width (480x640 frames, 16 response
channels, Fmax 128), after building the hand-written CUDA kernels K1
(ColorGradient quantizer), K2 (spread + response) and K3 (local walk)
from csrc/.  Phases, one JSON line each:

  0. card label (nvidia-smi) and the kernel build;
  1. K1 and K2 against their plain PyTorch versions on the card, bitwise,
     at the main path's shapes (B=32 at 480x640 and 240x320), with CUDA
     event times of both and each launch's bound (ops/roofline.py); then
     on odd shapes (widths off the kernels' tiles and off 4, 1- and 7-row
     frames, 1x1 and 3x3 frames; K1 on u8 and f32, K2 at T=5 and 8 into a
     channel slice of a wider stack whose other channels keep their
     bytes);
  2a. the untiled 2652-template bank on the 8-frame golden batch: Matches,
      n_valid, PooledStats and R0/R1 hashes equal the JAX reference's
      (tests/data/torch_port_golden.npz);
  2b. B=32 over the bank tiled to 10,624 templates: the kernel path equals
      the plain path (every Matches field); launch counts of K1/K2/K3 in
      that run, PooledStats, found rate, batch time;
  2c. the same batch with pool_coarse forced tiny: the exhaustive fallback
      runs and the Matches equal 2b's;
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
      240x320 f32; timed with its bound) and on ODD_SHAPES; train_and_write
      in both modes (RGB-only, ColorGradient + DepthNormal) over the
      golden's 32 views against tests/data/torch_trainer_golden.npz (the
      templates YAML byte-identical, the params equal with D within
      D_TOL); trained view 0 re-rendered and matched: template 0 at >= 95;
      train_from_stl in RGB-D over TRAIN_VIEWS views: views/s, wall, the
      host's dispatch / wait / extract seconds, each chunk's device span,
      busy share, peak memory, launch counts (K4 x1 and K1 x2 a chunk, and
      no plain version called); then `python -m
      linemod_pose_estimation_tpu_torch train` as a subprocess on the card
      over the golden's views, its JSON line and files against the golden.

Then a kernels summary line (per kernel: launches on its path, the
summed time, plain time and bound of those launches at their shapes,
what bounds it, the share of the bound, and library_ms null: no single
PyTorch call computes any of these functions; the other timed shapes
are rows of its `shapes`), the card line, and last
{"ok": true, "device": {...}}.  Any failed check raises, and the script
exits non-zero without printing the last line.  It needs CUDA: without a
card it exits 2 before doing anything.

    python3 chip_smoke.py --only options
    python3 chip_smoke.py --only serving
    python3 chip_smoke.py --only trainer

build the kernels and run phase 10, 11 or 12 alone (a quick check on a
card); they print no summary and no last line.
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
}


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
    from linemod_pose_estimation_tpu_torch.ops import _build
    from linemod_pose_estimation_tpu_torch.ops import local_descriptor as TL
    from linemod_pose_estimation_tpu_torch.ops import raster as RA
    from linemod_pose_estimation_tpu_torch.utils import pointcloud as TP
    from linemod_pose_estimation_tpu_torch.utils import scenes as S

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
    _build.reset_launch_counts()
    detect(base, 0)
    rows["default"]["launches_per_detect"] = dict(_build.launch_counts)
    outside, pipes, launches_acc = [], {}, None
    for cfg, (options, frame_ids) in TC.GOLDEN_OPTION_SETS.items():
        require(tuple(og[cfg + "_frames"]) == tuple(frame_ids),
                f"{cfg}: the golden holds other frames")
        pipe = pipes[cfg] = make(options)
        detect(pipe, 0)  # warm-up
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        results = [detect(pipe, f, return_stages=True) for f in frame_ids]
        torch.cuda.synchronize()
        launches = dict(_build.launch_counts)
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
        _build.reset_launch_counts()
        icp = calls_of(spied, lambda: detect(pipe, 0), results=True)
        ld = icp.pop("get_pose_by_local_descriptor", [])
        per_detect = dict(_build.launch_counts)
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
    from linemod_pose_estimation_tpu_torch.ops import _build
    from linemod_pose_estimation_tpu_torch.ops import cuda_kernels as CK
    from linemod_pose_estimation_tpu_torch.ops import cuda_preprocess as CP
    from linemod_pose_estimation_tpu_torch.ops import features as F
    from linemod_pose_estimation_tpu_torch.ops import match as M
    from linemod_pose_estimation_tpu_torch.ops import raster as RA
    from linemod_pose_estimation_tpu_torch.ops import roofline as RL
    from linemod_pose_estimation_tpu_torch.utils import kernel_cases as KC
    from linemod_pose_estimation_tpu_torch.utils import pointcloud as TP
    from linemod_pose_estimation_tpu_torch.utils import scenes as S

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
    _build.reset_launch_counts()
    results = [pipe.detect(r, c, threshold=thr, depth_mm=d, return_stages=True)
               for r, c, d in frames]
    torch.cuda.synchronize()
    launches6 = dict(_build.launch_counts)
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
    _build.reset_launch_counts()
    pipe.detect(*frames[0][:2], threshold=thr, depth_mm=frames[0][2])
    per_detect = dict(_build.launch_counts)
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
    from linemod_pose_estimation_tpu_torch.ops import _build
    from linemod_pose_estimation_tpu_torch.ops import cuda_kernels as CK
    from linemod_pose_estimation_tpu_torch.ops import match as M
    from linemod_pose_estimation_tpu_torch.utils import kernel_cases as KC

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
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    R0, cands, m5 = chain()
    torch.cuda.synchronize()
    chain_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(_build.launch_counts)
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
    from linemod_pose_estimation_tpu_torch.ops import _build

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
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    merged = mk.match_batch(rgbs, deps)
    torch.cuda.synchronize()
    merged_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(_build.launch_counts)
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
    from linemod_pose_estimation_tpu_torch.ops import _build

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
        _build.reset_launch_counts()
        got = m.match_batch(rgbs, deps)
        torch.cuda.synchronize()
        launches = dict(_build.launch_counts)
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
    _build.reset_launch_counts()
    got = mc.match_batch(rgbs, deps)
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
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
    _build.reset_launch_counts()
    R0, cands, n_valid = rm.candidates(rgbs)
    got = rm.refine(R0, cands, n_valid)
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
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
    from linemod_pose_estimation_tpu_torch.ops import _build
    from linemod_pose_estimation_tpu_torch.ops import raster as RA
    from linemod_pose_estimation_tpu_torch.utils import scenes as S
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
    _build.reset_launch_counts()
    answers = []
    for f in range(nf):
        cur["f"] = f
        answers.append(svc.linemod_object_pose(0))
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
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
    _build.reset_launch_counts()
    svc.linemod_object_pose(0)
    torch.cuda.synchronize()
    per_request = dict(_build.launch_counts)
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
    _build.reset_launch_counts()
    template_refinement(*first_refinement)
    torch.cuda.synchronize()
    refine_launches = dict(_build.launch_counts)
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
    _build.reset_launch_counts()
    st.step(*batches[0])
    torch.cuda.synchronize()
    per_step = dict(_build.launch_counts)
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
    from linemod_pose_estimation_tpu_torch.ops import _build
    from linemod_pose_estimation_tpu_torch.ops import cuda_preprocess as CP
    from linemod_pose_estimation_tpu_torch.ops import features as F
    from linemod_pose_estimation_tpu_torch.ops import raster as RA
    from linemod_pose_estimation_tpu_torch.ops import roofline as RL
    from linemod_pose_estimation_tpu_torch.utils import scenes as S
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
    emit("trainer_kernels_vs_plain", K4=perf["raster_zbuffer"][f"trainer_{B}x{W}x{H}"],
         K1={k: v for k, v in perf["quantize_cg"].items() if k.startswith("trainer")})
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
    _build.reset_launch_counts()
    plain = calls_of([(RA, "raster_zbuffer_plain"), (F, "quantize_color_gradient")],
                     lambda: TTR.train_from_stl(stl, c, max_views=TRAIN_VIEWS, device=dev,
                                                stats=stats))
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    n = stats["chunks"]
    require(launches["raster_zbuffer"] == n and launches["quantize_cg"] == 2 * n,
            f"trainer: {launches} over {n} chunks (want K4 x1, K1 x2 a chunk)")
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

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.library()
    emit("build", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         build_s=time.perf_counter() - t0, nvcc_s=_build.last_build_seconds)
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
    n0 = F.quantize_depth_normal(deps)
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
    emit("kernels_vs_plain", K1=perf["quantize_cg"], K2=perf["spread_response"])

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
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    m_kern = main_m.match_batch(rgbs, deps)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    for k in ("quantize_cg", "spread_response", "walk_scores"):  # this path's kernels
        require(launches[k] > 0, f"kernel {k} was not launched on the main path")
    stats = main_m.last_pool
    require(not bool(stats.fallback), "the main-path batch fell back; it must "
            "exercise the pooled branch")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        main_m.match_batch(rgbs, deps)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    m_plain = plain_m.match_batch(rgbs, deps)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
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
    t0 = time.perf_counter()
    R0, c_fb, nv_fb = fb.candidates(rgbs, deps)
    m_fb = fb.refine(R0, c_fb, nv_fb)
    torch.cuda.synchronize()
    fb_s = time.perf_counter() - t0
    require(bool(fb.last_pool.fallback), "forced tiny pool did not fall back")
    _, c_pool, nv_pool = main_m.candidates(rgbs, deps)
    require(torch.equal(nv_fb, nv_pool), "fallback n_valid != pooled n_valid")
    require(valid_equal(c_fb, c_pool), "fallback candidates != pooled candidates")
    require(valid_equal(m_fb, m_kern), "fallback matches != pooled matches")
    emit("forced_fallback", fallback=True, equal_valid_candidates=True,
         n_valid=nv_fb.tolist(), equal_valid_matches=True, batch_ms=fb_s * 1e3)

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

    # -- summary -------------------------------------------------------------
    # launches: of one B=32 pooled batch (phase 2b) for K1-K3, of one detect
    # (phase 6) for K2b and K4, of one K5 chain (phase 7) for K5.  ms, plain
    # and bound: summed over the shapes of those launches; the other timed
    # shapes (K3 over all slots and at detect's B=1, K4 at 8 poses, on the
    # 640x480 frame, on detect's own operands and on the accuracy detect's 16
    # lanes; K1's magnitude variant and K4 at the trainer's chunk) are rows of
    # `shapes`.
    off_path = ("all_slots", "detect_B1", "cascade_8x256x256", "frame_640x480",
                "detect_captured", "accuracy_captured", "refine_round_captured",
                "template_refinement_captured", "trainer_16x640x480",
                "trainer_level0_u8_16x480x640", "trainer_level1_f32_16x240x320")
    launches_of = {"spread_response_b1": (per_detect["spread_response"], "one detect"),
                   "raster_zbuffer": (per_detect["raster_zbuffer"], "one detect"),
                   "refine_scores": (launches7["refine_scores"], "one K5 chain")}
    summary = []
    for key, (name, src, replaces) in KERNELS.items():
        shapes = perf[key]
        main_shapes = [s for s, v in shapes.items() if "ms" in v and s not in off_path]
        n, per = launches_of[key] if key in launches_of else (
            launches[key], "one B=32 pooled batch")
        ms = sum(shapes[s]["ms"] for s in main_shapes)
        bound_ms = sum(shapes[s]["bound"]["ms"] for s in main_shapes)
        by = max(main_shapes, key=lambda s: shapes[s]["bound"]["ms"])
        summary.append(dict(
            name=f"{name} {key}", route="cuda", source=src, replaces=replaces,
            launches=n, launches_per=per,
            max_abs_err=max(v["max_abs_err"] for v in shapes.values()),
            ms=ms, plain_ms=sum(shapes[s]["plain_ms"] for s in main_shapes),
            bound_ms=bound_ms, bound_by=shapes[by]["bound"]["by"],
            share_of_bound=bound_ms / ms, library_ms=None,
            library_note="no single PyTorch call computes it",
            launches_per_detect=per_detect.get(key.removesuffix("_b1")),
            launches_per_positions_batch=launches9.get(key),
            launches_per_accuracy_detect=launches10.get(key.removesuffix("_b1")),
            launches_per_serving_request=launches11.get(key.removesuffix("_b1")),
            launches_per_streaming_step=launches_step.get(key.removesuffix("_b1")),
            launches_per_trainer_chunk=launches12.get(key.removesuffix("_b1")),
            shapes=shapes))
    print(json.dumps({"kernels": summary}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
