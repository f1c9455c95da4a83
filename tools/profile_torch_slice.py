"""Where a batched path of the port spends its time, on one NVIDIA GPU.

    python tools/profile_torch_slice.py [--path pooled|positions|two_axis|k5|two_object]
                                        [--batch 32] [--iters 3] [--top 25]

Runs chip_smoke.py's B=32 bin-picking batch over the RGB-D bank tiled to
10,624 templates through the kernel path of one of:

- `pooled` (phase 2b): BatchedMatcher(**slice_settings(B)) — candidates
  from the pooled matcher, then the walk;
- `positions`, `two_axis` (phase 9): BatchedMatcher(prune=True,
  prune_mode=..., top_k=128) at the default caps — candidates from the
  per-frame-cap matcher, then the walk over every slot; `positions` also
  prints the matcher's own stages (the coarse plan, the fine bound and
  plan, the exact survivor GEMM, the select), each bracketed by a sync;
- `k5` (phase 7): BatchedMatcher(prune=False, top_k=128) — candidates
  from the exhaustive GEMM and select, then the K5 window refiner
  (refine_candidates_pallas_batched);
- `two_object` (phase 8): MultiClassBatchedMatcher(prune_mode="pooled")
  over the bank under two class ids (2 x 10,624 templates), thresholds
  92 / 94, pools 56 B / 36 B — the merged pooled pass, then merge, walk
  and split; as in phase 8 the batch's last four frames are the frames of
  tests/data/torch_cascade_golden.npz.

First host-clock stage times bracketed by torch.cuda.synchronize()
(preprocess / candidates / refine), then a torch.profiler trace of
`--iters` whole batches: self device time by aten op and by kernel, and
the device busy share (traced kernel time over the untraced batch time).
Prints JSON lines; needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", default="pooled",
                    choices=("pooled", "positions", "two_axis", "k5", "two_object"))
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_slice: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from linemod_pose_estimation_tpu_torch.models.detector import Detector
    from linemod_pose_estimation_tpu_torch.models.serving import (
        BatchedMatcher, MultiClassBatchedMatcher, slice_settings)
    from linemod_pose_estimation_tpu_torch.models.templates import TemplateBank
    from linemod_pose_estimation_tpu_torch.ops import match as M
    from linemod_pose_estimation_tpu_torch.utils import scenes as S

    dev = torch.device("cuda")
    B = args.batch
    det = Detector.read(os.path.join(REPO, "data", "boxNew_rgbd_templates.yml.gz"))
    cid = det.class_ids[0]
    bank = det.bank(cid)
    reps = -(-10240 // bank.num_templates)
    det.attach_bank(bank.tile(reps, 10624))
    rgbs_np, deps_np, _ = S.bin_picking_batch(B, seed=3)
    rgbs = torch.from_numpy(rgbs_np).to(dev)
    deps = torch.from_numpy(deps_np).to(dev)
    if args.path == "pooled":
        m = BatchedMatcher(det, cid, 91.0, B, device=dev, **slice_settings(B))
        candidates = lambda: m.candidates(rgbs, deps)
        refine = lambda c: m.refine(*c)
    elif args.path in ("positions", "two_axis"):
        m = BatchedMatcher(det, cid, 91.0, B, top_k=128, prune=True,
                           prune_mode=args.path, device=dev)
        candidates = lambda: m.candidates(rgbs, deps)
        refine = lambda c: m.refine(*c)
    elif args.path == "k5":
        m = BatchedMatcher(det, cid, 91.0, B, top_k=128, device=dev)
        candidates = lambda: m.candidates(rgbs, deps)
        refine = lambda c: M.refine_candidates_pallas_batched(
            c[0], m.feats0, c[1], m.T1, 91.0, m.E0, fine_T=m.T0)
    else:
        with np.load(os.path.join(REPO, "tests", "data", "torch_cascade_golden.npz")) as z:
            g_rgbs, g_deps = (torch.from_numpy(z[k]).to(dev) for k in ("rgb", "depth_mm"))
        rgbs = torch.cat([rgbs[:B - len(g_rgbs)], g_rgbs])
        deps = torch.cat([deps[:B - len(g_deps)], g_deps])
        second = TemplateBank(cid + "_second", bank.params, bank.templates)
        det.attach_bank(second.tile(reps, 10624))
        m = MultiClassBatchedMatcher(det, [cid, second.class_id], [92.0, 94.0], B,
                                     top_k=128, prune_mode="pooled",
                                     pool_coarse=56 * B, pool_fine=36 * B, device=dev)
        candidates = lambda: m.candidates(rgbs, deps)
        refine = lambda c: m.refine(*c)
    run = lambda: refine(candidates())
    run()  # warm-up

    def stages():
        out = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        M.preprocess_frames_batched(rgbs, deps, m.T0, m.T1, True, m.weak)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        c = candidates()  # includes a preprocess
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        refine(c)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        out["preprocess_ms"] = (t1 - t0) * 1e3
        out["candidates_ms"] = (t2 - t1 - (t1 - t0)) * 1e3
        out["refine_ms"] = (t3 - t2) * 1e3
        return out

    for _ in range(args.iters):
        print(json.dumps({"path": args.path, "stages": stages()}), flush=True)

    def positions_stages():
        """The positions matcher's stages on the batch's level-1 responses,
        as match_coarse_pruned_fine_with_fallback runs them when nothing
        overflows."""
        _, R1 = M.preprocess_frames_batched(rgbs, deps, m.T0, m.T1, True, m.weak)
        w, count, thr = m.weights, m.feats1.count, m.threshold - 5.0
        Wc = R1.shape[3] // m.T1
        vpos = m._vpos_flat(R1.shape[2] // m.T1, Wc)
        out, state = {}, {}

        def stage(name, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state[name] = fn()
            torch.cuda.synchronize()
            out[name + "_ms"] = (time.perf_counter() - t0) * 1e3

        stage("coarse_plan", lambda: M.prune_positions_batched(
            R1, w.W_cell, count, vpos, thr, m.T1, m.Kc1, m.prune_pos_cap))
        pp = state["coarse_plan"]
        stage("fine_bound", lambda: M.fine_ub_at_survivors(
            R1, pp.p_idx, w.W_fine, m.T1, m.Kc1, m.fine_g))
        stage("fine_plan", lambda: M.fine_plan_from_ub(
            state["fine_bound"], count, vpos, pp.p_idx, pp.p_keep, thr, m.fine_pos_cap))
        fp = state["fine_plan"]
        stage("survivor_gemm", lambda: M.coarse_scores_gemm_flat_batched_pos(
            R1, w.W_gemm, fp.p_idx, m.T1, m.Kc1))
        stage("select", lambda: M.select_candidates_flat_pos(
            state["survivor_gemm"], count, vpos, fp.p_idx.long(), fp.p_keep, thr,
            m.top_k, Wc))
        out["coarse_survivors"] = int(pp.m_survivors.sum())
        out["fine_survivors"] = int(fp.m_survivors.sum())
        out["rows"] = dict(fine_bound=int(pp.p_idx.numel()), survivor_gemm=int(fp.p_idx.numel()))
        return out

    if args.path == "positions":
        for _ in range(args.iters):
            print(json.dumps({"path": args.path, "matcher_stages": positions_stages()}),
                  flush=True)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        run()
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t0) * 1e3 / args.iters

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

    from torch.autograd import DeviceType

    events = prof.key_averages()
    kernels = sorted(((dev_us(e), e.key, e.count) for e in events
                      if e.device_type == DeviceType.CUDA), reverse=True)
    ops = sorted(((dev_us(e), e.key, e.count) for e in events
                  if e.device_type == DeviceType.CPU and dev_us(e) > 0), reverse=True)
    busy_ms = sum(k[0] for k in kernels) / 1e3
    # The profiler slows the host side many times over, so the busy share
    # divides traced device time by the untraced batch time.
    print(json.dumps({"trace": {
        "path": args.path, "batches": args.iters, "batch_ms_untraced": batch_ms,
        "device_ms_per_batch": busy_ms / args.iters,
        "device_busy_share": busy_ms / args.iters / batch_ms,
        "card": torch.cuda.get_device_name(0)}}), flush=True)
    for kind, rows in (("op", ops), ("kernel", kernels)):
        for us, key, count in rows[:args.top]:
            print(json.dumps({kind: key[:120], "device_ms_per_batch": us / 1e3 / args.iters,
                              "calls_per_batch": count / args.iters}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
