"""Streaming multi-camera batched inference on the card — the port of
tools/bench_streaming.py, on in-repo data only.

N paced replay cameras (fixed sensor cadence, ring-buffer backlog) ->
FrameBatcher.poll_batch -> the B=32 pooled BatchedMatcher over the RGB-D
bank tiled to 10,624 templates -> the pose stage on the batch's
best-scoring frame, with two batches in flight (PipelinedRunner, depth
2).  The cameras cycle over 32 scenes: the 28 bin-picking scenes of
chip_smoke.py phase 8 (rendered views planted on a flat background; best
similarity ~84, so nothing is valid at 91) and the 4 frames of
tests/data/torch_cascade_golden.npz (the cuboid stand-in for the boxNew
mesh, which the reference bench renders from an STL this repo does not
hold; they reach 96-99, the background frame nothing).  The pose stage is
DetectionPipeline's, in the accuracy configuration with canonicalize
"none" (the reference bench's pose configuration) over the bank's
metadata tiled as the features are; the reference bench's own pose stage
suppresses before the pose, the library's accuracy configuration after
it, over twice the slots.

A run prints one JSON record with the reference's keys for a paced run
(offered load ~0.9 x the measured step capacity) and a saturated run
(cameras at 2 x capacity): sustained fps, per-frame end-to-end latency
(grab stamp -> result on the host) p50/p90/p99, batch fill, drops,
cascade events, fallback batches.  Frames reach the card as pageable
numpy copies inside the step.

`--e2e` prints instead the three numbers of the reference bench's real
end-to-end probe on one frame (the first cascade frame) through the B=1
pooled matcher and the same pose stage: the blocking p50 of one frame's
match + pose, the per-frame time of back-to-back frames with one wait at
the end, and the p50 per submit through PipelinedRunner(depth=2).

    python tools/bench_streaming_torch.py [--secs 30] [--cams 8] [--batch 32]
        [--fps F] [--tile 10624] [--device cuda] [--out PATH]
    python tools/bench_streaming_torch.py --e2e [--iters 15]

The flags replace the reference's LPE_STREAM_* environment variables.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import deque
from types import SimpleNamespace
from typing import NamedTuple

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

BANK = os.path.join(REPO, "data", "boxNew_rgbd_templates.yml.gz")
PARAMS = os.path.join(REPO, "data", "boxNew_rgbd_params.yml.gz")
CASCADE_GOLDEN = os.path.join(REPO, "tests", "data", "torch_cascade_golden.npz")
THRESHOLD = 91.0
TILE_TO = 10624


class StepOut(NamedTuple):
    valid: torch.Tensor  # (B, top_k) valid matches of the batch
    pose: torch.Tensor  # (lanes, 4, 4) the best frame's poses
    pose_valid: torch.Tensor  # (lanes,)
    fallback: torch.Tensor  # () the pooled matcher fell back to the exhaustive GEMM
    best_frame: torch.Tensor  # () the frame the pose stage ran on


def scenes():
    """(rgbs (32, 480, 640, 3) u8, depths (32, 480, 640) f32 mm): the 28
    bin-picking scenes, then the 4 cascade frames."""
    from linemod_pose_estimation_tpu_torch.utils import scenes as S

    rgbs, deps, _ = S.bin_picking_batch(32, seed=3)
    with np.load(CASCADE_GOLDEN) as z:
        return (np.concatenate([rgbs[:28], z["rgb"]]),
                np.concatenate([deps[:28], z["depth_mm"]]).astype(np.float32))


class Streaming:
    """The tiled bank, the batch matcher and the pose stage on `device`."""

    def __init__(self, device="cuda", batch: int = 32, tile_to: int = TILE_TO):
        from linemod_pose_estimation_tpu_torch.models.cascade import (ACCURACY_OPTIONS,
                                                                      CascadeParams)
        from linemod_pose_estimation_tpu_torch.models.detector import Detector
        from linemod_pose_estimation_tpu_torch.models.pipeline import DetectionPipeline
        from linemod_pose_estimation_tpu_torch.models.serving import (BatchedMatcher,
                                                                      slice_settings)
        from linemod_pose_estimation_tpu_torch.models.templates import (TemplateBank,
                                                                        TemplateMetadata)
        from linemod_pose_estimation_tpu_torch.utils.scenes import cuboid_mesh

        self.device = torch.device(device)
        self.det = Detector.read(BANK, device=device)
        self.cid = cid = self.det.class_ids[0]
        bank = self.det.bank(cid)
        n0 = bank.num_templates
        reps = max(1, tile_to // n0)
        tile_to = max(tile_to, reps * n0)
        self.det.attach_bank(bank.tile(reps, tile_to))
        self.batch = batch
        self.matcher = BatchedMatcher(self.det, cid, THRESHOLD, batch, device=device,
                                      **slice_settings(batch))
        self.single = None  # the B=1 matcher of one_frame, built on first use
        meta, glob = TemplateBank.read_params_yaml(PARAMS)
        rows = np.arange(tile_to) % n0  # the dead padding rows are never valid
        tiled = TemplateMetadata(R=meta.R[rows], T=meta.T[rows], K=meta.K[rows],
                                 D=meta.D[rows], Ori_dist=meta.Ori_dist[rows],
                                 Rect=meta.Rect[rows])
        params = CascadeParams(**{**ACCURACY_OPTIONS, "canonicalize": "none"})
        self.pipe = DetectionPipeline(self.det, tiled, glob, cuboid_mesh(), params,
                                      class_id=cid)

    def _pose(self, m, b, depths):
        from linemod_pose_estimation_tpu_torch.ops.match import Matches
        from linemod_pose_estimation_tpu_torch.utils import pointcloud as TP

        m1 = Matches(*(a[b] for a in m))
        cloud = TP.depth_to_cloud(TP.true_div(depths[b], 1000.0), self.pipe.K_render)
        poses = self.pipe._pose_stage(m1, cloud)[0]
        return poses.pose, poses.valid

    def step(self, rgbs, depths) -> StepOut:
        """One batch: match, then the pose stage on its best frame."""
        rgbs = torch.as_tensor(rgbs).to(self.device)
        depths = torch.as_tensor(depths).to(self.device)
        m = self.matcher.match_batch(rgbs, depths)
        b = torch.where(m.valid, m.similarity, -1.0).amax(dim=1).argmax()
        pose, pvalid = self._pose(m, b, depths)
        return StepOut(m.valid, pose, pvalid, self.matcher.last_pool.fallback, b)

    def one_frame(self, rgb, depth):
        """One frame (1, H, W, 3) through the B=1 matcher and the pose stage."""
        from linemod_pose_estimation_tpu_torch.models.serving import (BatchedMatcher,
                                                                      slice_settings)

        if self.single is None:
            self.single = BatchedMatcher(self.det, self.cid, THRESHOLD, 1, device=self.device,
                                         **slice_settings(1))
        rgb = torch.as_tensor(rgb).to(self.device)
        depth = torch.as_tensor(depth).to(self.device)
        return self._pose(self.single.match_batch(rgb, depth), 0, depth)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_stream(s: Streaming, frames, depths, n_cams: int, cam_fps: float, secs: float) -> dict:
    from linemod_pose_estimation_tpu_torch.models.serving import PipelinedRunner
    from linemod_pose_estimation_tpu_torch.parallel.ingest import FrameBatcher, PacedSource

    n_scenes = frames.shape[0]

    def make_cam(cid):
        state = {"i": cid}

        def grab():
            i = state["i"] % n_scenes
            state["i"] += 1
            return SimpleNamespace(rgb=frames[i], cloud=depths[i])

        return grab

    t_start = time.perf_counter()
    cams = [PacedSource(make_cam(c), cam_fps, start=t_start + c / (cam_fps * n_cams))
            for c in range(n_cams)]
    batcher = FrameBatcher(cams, s.batch)
    run = PipelinedRunner(s.step, depth=2, device=s.device)
    meta_q = deque()
    lats, fills = [], []
    events = fallbacks = done = 0
    t_end = t_start + secs

    def harvest(out: StepOut):
        nonlocal done, events, fallbacks
        stamps, n = meta_q.popleft()
        t_done = time.perf_counter()
        lats.extend(((t_done - stamps[:n]) * 1e3).tolist())
        fills.append(n)
        events += 1
        fallbacks += int(out.fallback)
        done += n

    while time.perf_counter() < t_end:
        got = batcher.poll_batch(time.perf_counter())
        if got is None:
            time.sleep(0.0005)
            continue
        rgbs, deps, stamps, n = got
        out = run.submit(rgbs, deps)
        meta_q.append((stamps, n))
        if out is not None:
            harvest(out)
    for out in run.drain():
        harvest(out)
    wall = time.perf_counter() - t_start
    lats, fills = np.asarray(lats), np.asarray(fills)
    return {
        "cameras": n_cams, "camera_fps": round(cam_fps, 1),
        "offered_fps": round(n_cams * cam_fps, 1), "batch": s.batch,
        "duration_s": round(wall, 2), "frames_processed": int(done),
        "sustained_fps": round(done / wall, 1),
        "latency_p50_ms": round(float(np.percentile(lats, 50)), 2),
        "latency_p90_ms": round(float(np.percentile(lats, 90)), 2),
        "latency_p99_ms": round(float(np.percentile(lats, 99)), 2),
        "batch_fill_mean": round(float(fills.mean()), 1),
        "batch_fill_p10": int(np.percentile(fills, 10)),
        "batch_fill_p90": int(np.percentile(fills, 90)),
        "steps": int(fills.size), "dropped_frames": int(sum(c.dropped for c in cams)),
        "cascade_events": int(events), "fallback_batches": int(fallbacks),
    }


def e2e(s: Streaming, frames, depths, iters: int = 15) -> dict:
    """The reference bench's three end-to-end numbers on one frame."""
    from linemod_pose_estimation_tpu_torch.models.serving import PipelinedRunner

    rgb, dep = frames[28:29], depths[28:29]  # the first cascade frame
    pose, valid = s.one_frame(rgb, dep)
    _sync(s.device)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        s.one_frame(rgb, dep)
        _sync(s.device)
        ts.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    for _ in range(iters):
        s.one_frame(rgb, dep)
    _sync(s.device)
    device_ms = (time.perf_counter() - t0) / iters * 1e3
    run = PipelinedRunner(s.one_frame, depth=2, device=s.device)
    run.submit(rgb, dep)
    tp = []
    for _ in range(2 * iters):
        t0 = time.perf_counter()
        run.submit(rgb, dep)
        tp.append((time.perf_counter() - t0) * 1e3)
    run.drain()
    return {"real_e2e_p50_ms": float(np.percentile(ts, 50)),
            "real_e2e_device_ms": float(device_ms),
            "real_e2e_pipelined_p50_ms": float(np.percentile(tp, 50)),
            "verified_hypotheses": int(valid.sum()), "iters": iters}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--secs", type=float, default=30.0, help="seconds per run")
    ap.add_argument("--cams", type=int, default=8)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--fps", type=float, default=None,
                    help="per-camera cadence of the paced run (default ~0.9 x capacity)")
    ap.add_argument("--tile", type=int, default=TILE_TO, help="bank rows after tiling")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--e2e", action="store_true", help="the one-frame end-to-end probe")
    ap.add_argument("--iters", type=int, default=15)
    ap.add_argument("--out", default=None, help="also write the record here")
    a = ap.parse_args()

    t0 = time.perf_counter()
    s = Streaming(a.device, a.batch, a.tile)
    frames, depths = scenes()
    setup_s = time.perf_counter() - t0
    card = torch.cuda.get_device_name(s.device) if s.device.type == "cuda" else "cpu"
    if a.e2e:
        out = {"config": "one frame: B=1 pooled matcher over the tiled bank + the pose stage",
               "device": card, "setup_s": setup_s, **e2e(s, frames, depths, a.iters)}
    else:
        idx = np.arange(a.batch) % frames.shape[0]
        r0, d0 = frames[idx], depths[idx]
        t1 = time.perf_counter()
        s.step(r0, d0)
        _sync(s.device)
        warm_s = time.perf_counter() - t1
        iters = 10
        t1 = time.perf_counter()
        for _ in range(iters):
            s.step(r0, d0)
        _sync(s.device)
        cap_fps = a.batch * iters / (time.perf_counter() - t1)
        cam_fps = a.fps or 0.9 * cap_fps / a.cams
        paced = run_stream(s, frames, depths, a.cams, cam_fps, a.secs)
        sat = run_stream(s, frames, depths, a.cams, cap_fps * 2.0 / a.cams, a.secs)
        out = {"config": ("N paced replay cameras -> FrameBatcher.poll_batch -> pooled "
                          "batched matcher + walk -> pose stage on the batch's best frame, "
                          "2 batches in flight (PipelinedRunner)"),
               "device": card, "setup_s": setup_s, "warmup_s": warm_s,
               "templates": s.det.bank(s.cid).num_templates,
               "step_capacity_fps": round(cap_fps, 1), "paced": paced, "saturated": sat}
    line = json.dumps(out)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
