"""Where one full-width DetectionPipeline.detect spends its time, on one
NVIDIA GPU.

    python tools/profile_torch_cascade.py [--iters 5] [--top 20] [--accuracy]
        [--refine-rounds N] [--icp-variant two_stage|point_to_plane|nonlinear]
        [--position-strategy surface_centroid|roi_center|distance_offset|local_descriptor]

Runs the chip_smoke.py phase 6 configuration (the 2652-template RGB-D
bank and its params, the cuboid stand-in for the boxNew mesh, default
CascadeParams, threshold 91), or with the options given phase 10's
(`--accuracy`: point-to-plane ICP, two orientation hypotheses, NMS after
the pose; the other options override single fields), on frame 0 of
tests/data/torch_cascade_golden.npz: first host-clock stage times, each
stage function wrapped so that it synchronizes before and after (so the
stage times include one sync each and sum to more than an untraced
detect); then a torch.profiler trace of `--iters` detects: device time by
kernel and the device busy share (traced kernel time over the untraced
detect time).  With the options the stages include the scene normals, the
point-to-plane or LM ICP, the in-plane sweep, the local-descriptor pose,
the hypothesis selection (both hypotheses run as lanes of one batch: the
line gives the lane count) and the NMS after the pose; a refinement round
shows as second calls of render, scene extraction, the filters and ICP.
Prints JSON lines; needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--accuracy", action="store_true",
                    help="the reference's accuracy configuration")
    ap.add_argument("--refine-rounds", type=int, default=None)
    ap.add_argument("--icp-variant", default=None)
    ap.add_argument("--position-strategy", default=None)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_cascade: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from linemod_pose_estimation_tpu_torch.models import cascade as CC
    from linemod_pose_estimation_tpu_torch.models.pipeline import DetectionPipeline
    from linemod_pose_estimation_tpu_torch.ops import local_descriptor as TL
    from linemod_pose_estimation_tpu_torch.ops import match as M
    from linemod_pose_estimation_tpu_torch.ops import verification as TV
    from linemod_pose_estimation_tpu_torch.utils import pointcloud as TP
    from linemod_pose_estimation_tpu_torch.utils.scenes import cuboid_mesh

    dev = torch.device("cuda")
    options = dict(CC.ACCURACY_OPTIONS) if args.accuracy else {}
    for name in ("refine_rounds", "icp_variant", "position_strategy"):
        if getattr(args, name) is not None:
            options[name] = getattr(args, name)
    pipe = DetectionPipeline.from_files(
        os.path.join(REPO, "data", "boxNew_rgbd_templates.yml.gz"),
        os.path.join(REPO, "data", "boxNew_rgbd_params.yml.gz"), cuboid_mesh(),
        CC.CascadeParams(**options), device=dev)
    print(json.dumps({"options": options}), flush=True)
    with np.load(os.path.join(REPO, "tests", "data", "torch_cascade_golden.npz")) as z:
        rgb, dep, thr = z["rgb"][0], z["depth_mm"][0], float(z["threshold"])
    dep_t = torch.from_numpy(dep).to(dev)
    cloud = TP.depth_to_cloud(TP.true_div(dep_t, 1000.0), pipe.K_render)
    run = lambda: pipe.detect(rgb, cloud, threshold=thr, depth_mm=dep_t)
    run()  # warm-up (cuBLASLt heuristics, the bank's device operands)

    # -- stage times: wrap each stage function with synchronizing timers --
    times: dict[str, list[float]] = defaultdict(list)
    icp_iters: list[list[int]] = []  # per ICP call of a detect, per lane

    def timed(mod, name, label):
        fn = getattr(mod, name)

        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            times[label].append((time.perf_counter() - t0) * 1e3)
            if hasattr(out, "iterations"):  # ICP: iterations per lane
                icp_iters.append(out.iterations.tolist())
            return out

        setattr(mod, name, wrapper)
        return fn

    stages = [
        (M, "preprocess_frame", "match: preprocess (K1, K2)"),
        (M, "coarse_scores_gemm", "match: exhaustive int8 GEMM"),
        (M, "select_candidates", "match: template-major top-512"),
        (M, "refine_candidates_opencv", "match: walk (K3)"),
        (CC, "cluster_matches", "cluster: vote cells"),
        (CC, "nms_iou", "cluster: IoU NMS"),
        (CC, "_orientation_cluster_average", "pose: orientation clustering"),
        (CC, "render_fn", "pose: render (K4)"),
        (CC, "_windowed_scene_extract", "pose: scene extraction"),
        (TP, "statistical_outlier_removal", "pose: SOR"),
        (TP, "voxel_grid_filter", "pose: voxel filters"),
        (CC, "icp_two_stage", "pose: two-stage ICP"),
        (CC, "icp_two_stage_plane", "pose: point-to-plane ICP"),
        (CC, "icp_nonlinear_schedule", "pose: LM ICP"),
        (CC, "inplane_sweep_fix", "pose: in-plane sweep"),
        (TL, "get_pose_by_local_descriptor", "pose: local-descriptor pose"),
        (TV, "depth_normals", "scene normals"),
        (CC, "select_hypothesis", "pose: hypothesis selection"),
        (CC, "nms_rects", "NMS after the pose"),
        (TP, "voxel_occupancy_rate", "pose: HV"),
    ]
    saved = [(mod, name, timed(mod, name, label)) for mod, name, label in stages]
    total = []
    for _ in range(args.iters):
        times.clear()
        icp_iters.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, st = pipe.detect(rgb, cloud, threshold=thr, depth_mm=dep_t, return_stages=True)
        torch.cuda.synchronize()
        total.append((time.perf_counter() - t0) * 1e3)
        print(json.dumps({"stages_ms": {k: sum(v) for k, v in times.items()},
                          "stage_calls": {k: len(v) for k, v in times.items() if len(v) > 1},
                          "detect_ms_with_stage_syncs": total[-1],
                          "lanes": int(st.poses.valid.numel())
                          * pipe.params.orientation_hypotheses,
                          "icp_iterations_per_call_and_lane": icp_iters}), flush=True)
    for mod, name, fn in saved:
        setattr(mod, name, fn)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        run()
    torch.cuda.synchronize()
    detect_ms = (time.perf_counter() - t0) * 1e3 / args.iters

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.iters):
            run()
        torch.cuda.synchronize()

    def dev_us(e):
        for name in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, name):
                return getattr(e, name)
        return 0.0

    events = prof.key_averages()
    kernels = sorted(((dev_us(e), e.key, e.count) for e in events
                      if e.device_type == DeviceType.CUDA), reverse=True)
    busy_ms = sum(k[0] for k in kernels) / 1e3 / args.iters
    n_launch = sum(k[2] for k in kernels) / args.iters
    print(json.dumps({"trace": {
        "detects": args.iters, "detect_ms_untraced": detect_ms,
        "device_ms_per_detect": busy_ms, "device_busy_share": busy_ms / detect_ms,
        "kernel_launches_per_detect": n_launch,
        "valid_lanes": int(st.poses.valid.sum()),
        "card": torch.cuda.get_device_name(0)}}), flush=True)
    for us, key, count in kernels[:args.top]:
        print(json.dumps({"kernel": key[:120], "device_ms_per_detect": us / 1e3 / args.iters,
                          "calls_per_detect": count / args.iters}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
