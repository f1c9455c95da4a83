"""Where the offline trainer spends its time, on one NVIDIA GPU.

    python tools/profile_torch_trainer.py [--views 640] [--reps 10]

At full width (the reference's TrainerConfig(): 640x480, fx 535.566011,
fy 537.168115, render_batch 16) on the cuboid stand-in for the boxNew
mesh, written as a binary STL:

- one chunk (the view sphere's first 16 views), stage by stage, each the
  median of `--reps` runs between its own pair of CUDA events after a
  warm-up: the render (per-triangle coefficients, K4, postprocess), K1's
  magnitude variant at level 0 (16 x 480x640 u8), the pyrDown, K1 at
  level 1 (16 x 240x320 f32), DepthNormal at level 0, and the copies of
  what the host needs into pinned buffers; then the whole chunk
  (`trainer._ChunkOnDevice`, RGB-D) and the host's time to queue it;
- the host's extraction (`trainer.add_views`) of that chunk, per view,
  RGB-only and RGB-D, median of 3;
- `train_from_stl` over the sphere's first `--views` views in each mode:
  the run's `stats` (views/s, wall, dispatch / wait / extract seconds,
  busy share, each chunk's device span);
- the card's name and power limit.

Prints JSON lines; needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def event_ms(fn, reps: int) -> list[float]:
    """Device ms of `reps` calls of fn(), each between its own pair of CUDA
    events, after one warm-up call."""
    import torch

    fn()
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--views", type=int, default=640)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_trainer: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from linemod_pose_estimation_tpu_torch.models import trainer as TTR
    from linemod_pose_estimation_tpu_torch.models.detector import Detector
    from linemod_pose_estimation_tpu_torch.models.renderer import Renderer, render
    from linemod_pose_estimation_tpu_torch.models.templates import DetectorParams
    from linemod_pose_estimation_tpu_torch.ops import cuda_preprocess as CP
    from linemod_pose_estimation_tpu_torch.ops import features as F
    from linemod_pose_estimation_tpu_torch.utils.scenes import cuboid_mesh
    from linemod_pose_estimation_tpu_torch.utils.stl import save_binary_stl
    from linemod_pose_estimation_tpu_torch.utils.viewsphere import generate_views

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    med = lambda v: float(np.median(v))
    with tempfile.TemporaryDirectory() as d:
        stl = os.path.join(d, "cuboid.stl")
        save_binary_stl(stl, cuboid_mesh().triangles)
        cfg = TTR.TrainerConfig()
        W, H, B = cfg.width, cfg.height, cfg.render_batch
        rgbd = DetectorParams(use_depth_normal=True)
        views = generate_views(cfg.view_sphere)[:B]
        r = Renderer(stl, W, H, cfg.focal_length_x, cfg.focal_length_y, device=dev)
        Rs = torch.as_tensor(np.stack([v.R for v in views]), dtype=torch.float32, device=dev)
        Ts = torch.as_tensor(np.stack([v.T for v in views]), dtype=torch.float32, device=dev)
        K = r.K.expand(B, 3, 3)

        # -- one chunk, stage by stage ------------------------------------
        out = render(r.triangles, Rs, Ts, K, W, H)
        rgb1 = torch.stack([F.pyr_down(out.rgb[..., c]) for c in range(3)], -1).contiguous()
        arrays = TTR.chunk_arrays(out, rgbd)
        pinned = TTR._pinned_buffers(B, H, W, rgbd)

        def d2h():
            for a, b in zip(arrays, pinned):
                b.copy_(a, non_blocking=True)

        stages = {
            "render (coefficients, K4, postprocess)": lambda: render(r.triangles, Rs, Ts, K, W, H),
            "K1 level 0 (u8, with mag2)": lambda: CP.quantize_color_gradient_mag2(out.rgb),
            "pyrDown": lambda: [F.pyr_down(out.rgb[..., c]) for c in range(3)],
            "K1 level 1 (f32, with mag2)": lambda: CP.quantize_color_gradient_mag2(rgb1),
            "DN level 0": lambda: CP.quantize_depth_normal(
                out.depth_mm, rgbd.depth.distance_threshold, rgbd.depth.difference_threshold),
            "D2H into pinned buffers": d2h,
        }
        rows = {name: med(event_ms(fn, args.reps)) for name, fn in stages.items()}
        buf = [TTR._pinned_buffers(B, H, W, rgbd) for _ in range(2)]
        chunk_ms, queue_ms = [], []
        for i in range(args.reps + 1):
            t0 = time.perf_counter()
            c = TTR._ChunkOnDevice(r, Rs, Ts, rgbd, buf[i % 2])
            queue_ms.append((time.perf_counter() - t0) * 1e3)
            chunk_ms.append(c.wait())
        print(json.dumps({"chunk_stages_ms": rows, "stages_sum_ms": sum(rows.values()),
                          "chunk_device_ms": med(chunk_ms[1:]),
                          "chunk_queue_host_ms": med(queue_ms[1:]),
                          "d2h_bytes": int(sum(a.numel() * a.element_size() for a in arrays)),
                          "views": B, "width": W, "height": H}), flush=True)

        # -- the host's extraction of that chunk ----------------------------
        host = {}
        for mode, use_depth in (("rgb", False), ("rgbd", True)):
            p = DetectorParams(use_depth_normal=use_depth)
            a = [x.cpu().numpy() for x in TTR.chunk_arrays(out, p)]
            per = []
            for _ in range(3):
                det = Detector(p, device=dev)
                t0 = time.perf_counter()
                TTR.add_views(det, "obj", a)
                per.append((time.perf_counter() - t0) * 1e3 / B)
            host[mode] = med(per)
        print(json.dumps({"host_extract_ms_per_view": host}), flush=True)

        # -- whole runs -----------------------------------------------------
        for mode, use_depth in (("rgb", False), ("rgbd", True)):
            c = TTR.TrainerConfig(detector=DetectorParams(use_depth_normal=use_depth))
            TTR.train_from_stl(stl, c, max_views=B, device=dev)  # warm-up
            stats = {}
            TTR.train_from_stl(stl, c, max_views=args.views, device=dev, stats=stats)
            ms = stats.pop("chunk_device_ms")
            print(json.dumps({"train_from_stl": mode, "views_per_s": stats["views"]
                              / stats["wall_s"], "chunk_device_ms_median": med(ms),
                              **stats}), flush=True)
    print(json.dumps({"card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
