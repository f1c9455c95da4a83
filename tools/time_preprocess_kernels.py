"""Time the preprocess kernels K1 and K2 of one checkout of the port, on
one NVIDIA GPU, at the main path's shapes.

    python tools/time_preprocess_kernels.py [--repo DIR] [--reps 50]

`--repo` is the root of a checkout (default: this one), so two commits
compare in one session by running the script once per checkout, in turns
(parent, change, change, parent).  It uses only calls that every version
of the port has: `cuda_preprocess.quantize_color_gradient`,
`cuda_kernels.spread_response(q, T)`, `match.preprocess_frames_batched`
and `BatchedMatcher(..., device=...).match_batch`.

On chip_smoke.py's B=32 bin-picking batch (480x640, seed 3) it prints one
JSON line with:
- K1 at level 0 (u8 480x640) and level 1 (f32 240x320), and K2 at its
  four main-path calls (ColorGradient and DepthNormal at T=5 480x640 and
  T=8 240x320): ms per call over `--reps` back-to-back calls (CUDA
  events, after a warm-up; for a kernel shorter than the wrapper's host
  work this is the host's launch rate), the kernel's own device time per
  launch (torch.profiler), and the per-batch sums of both (2 K1, 4 K2
  launches);
- the preprocess stage (`preprocess_frames_batched`, RGB-D): mean device
  ms over 10 calls, and the counts of `aten::cat` and `aten::stack` calls
  in one traced call;
- the B=32 pooled batch over the bank tiled to 10,624 templates
  (chip_smoke phase 2b): host ms of 5 `match_batch` calls, each ended by a
  device sync, after a warm-up;
- the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def cuda_ms(fn, reps: int) -> float:
    import torch

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


def device_ms(fn, kernel: str, reps: int) -> float:
    """torch.profiler's CUDA time per launch of the kernels whose name holds
    `kernel` (0 if the trace holds no device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and kernel in e.key) / 1e3 / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_preprocess_kernels: needs a CUDA device", file=sys.stderr)
        return 2
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    from linemod_pose_estimation_tpu_torch.models.detector import Detector
    from linemod_pose_estimation_tpu_torch.models.serving import BatchedMatcher, slice_settings
    from linemod_pose_estimation_tpu_torch.ops import _build
    from linemod_pose_estimation_tpu_torch.ops import cuda_kernels as CK
    from linemod_pose_estimation_tpu_torch.ops import cuda_preprocess as CP
    from linemod_pose_estimation_tpu_torch.ops import features as F
    from linemod_pose_estimation_tpu_torch.ops import match as M
    from linemod_pose_estimation_tpu_torch.utils import scenes as S

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _build.library()
    B = 32
    rgbs_np, deps_np, _ = S.bin_picking_batch(B, seed=3)
    rgbs = torch.from_numpy(rgbs_np).to(dev)
    deps = torch.from_numpy(deps_np).to(dev)
    rgb1 = torch.stack([F.pyr_down(rgbs[..., c].float()) for c in range(3)], -1).contiguous()
    k1 = {name: cuda_ms(lambda x=x: CP.quantize_color_gradient(x, 10.0), args.reps)
          for name, x in (("level0_u8_480x640", rgbs), ("level1_f32_240x320", rgb1))}
    q0 = CP.quantize_color_gradient(rgbs, 10.0)
    q1 = CP.quantize_color_gradient(rgb1, 10.0)
    n0 = F.quantize_depth_normal(deps)
    n1 = n0[:, ::2, ::2].contiguous()
    k2 = {name: cuda_ms(lambda q=q, T=T: CK.spread_response(q, T), args.reps)
          for name, q, T in (("grad_T5_480x640", q0, 5), ("grad_T8_240x320", q1, 8),
                             ("norm_T5_480x640", n0, 5), ("norm_T8_240x320", n1, 8))}
    k1_dev = {name: device_ms(lambda x=x: CP.quantize_color_gradient(x, 10.0),
                              "quantize_cg_kernel", args.reps)
              for name, x in (("level0_u8_480x640", rgbs), ("level1_f32_240x320", rgb1))}
    k2_dev = {name: device_ms(lambda q=q, T=T: CK.spread_response(q, T),
                              "spread_response_kernel", args.reps)
              for name, q, T in (("grad_T5_480x640", q0, 5), ("grad_T8_240x320", q1, 8),
                                 ("norm_T5_480x640", n0, 5), ("norm_T8_240x320", n1, 8))}
    pre = lambda: M.preprocess_frames_batched(rgbs, deps, use_depth=True)
    pre_ms = cuda_ms(pre, 10)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        pre()
        torch.cuda.synchronize()
    joins = {k: sum(e.count for e in prof.key_averages() if e.key == k)
             for k in ("aten::cat", "aten::stack")}

    det = Detector.read(os.path.join(repo, "data", "boxNew_rgbd_templates.yml.gz"), device=dev)
    cid = det.class_ids[0]
    bank = det.bank(cid)
    det.attach_bank(bank.tile(-(-10240 // bank.num_templates), 10624))
    m = BatchedMatcher(det, cid, 91.0, B, device=dev, **slice_settings(B))
    m.match_batch(rgbs, deps)
    torch.cuda.synchronize()
    batch_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        m.match_batch(rgbs, deps)
        torch.cuda.synchronize()
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps(dict(
        repo=repo, card=card, K1_ms=k1, K1_batch_ms=sum(k1.values()),
        K1_device_ms=k1_dev, K1_batch_device_ms=sum(k1_dev.values()), K2_ms=k2,
        K2_batch_ms=sum(k2.values()), K2_device_ms=k2_dev,
        K2_batch_device_ms=sum(k2_dev.values()), preprocess_ms=pre_ms, preprocess_join_calls=joins,
        batch_ms=batch_ms, batch_ms_median=float(np.median(batch_ms)))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
