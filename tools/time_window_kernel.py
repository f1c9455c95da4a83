"""Time kernel K5 (the dense window scores) of one checkout of the port on
one NVIDIA GPU, on the K5 chain's plan, by three clocks, with the chain
around it.

    python tools/time_window_kernel.py [--repo DIR] [--reps 20] [--rounds 5]

`--repo` is the root of a checkout (default: this one), so two commits
compare on one card by running the script once per checkout, in turns
(parent, change, change, parent).  It uses only calls that every version
of the port has: `BatchedMatcher.candidates`, `match.window_plan` and
`cuda_kernels.refine_scores`.

The operands are fixed: chip_smoke phase 7's plan (the B=32 bin-picking
batch over the bank tiled to 10,624 templates, `BatchedMatcher(prune=
False, top_k=128)`: 4096 candidates, a 24 x 24 window, Fmax 128).  Each of
`--rounds` rounds reads, in ms per launch after a warm-up launch:

- `profiler`: torch.profiler's device time of the kernel over `--reps`
  launches, with `trace_launches`, the launches the trace really holds
  (a trace that lost records reads short by their share);
- `events_back_to_back`: CUDA events around `--reps` launches in a row;
- `events_single`: CUDA events around one launch, the median and the
  least of `--reps`, each launch started on an idle device;
- `events_single_flushed`: the same after a 256 MB write that evicts L2
  (the median), and `events_single_after_plain` after one run of the
  plain version (the state a kernel-against-plain check leaves);
- `events_single_after_idle`: the same after 0.2 s of host sleep (the
  card may have dropped its clocks).

After the rounds it reads `K5_hot_ms`, CUDA events around `--reps`
launches in a row on the same plan with every offset 0 and every feature
on plane 0 of its frame: each candidate then reads the same 24 rows for
every feature, from L1, so the time left is what the instructions and
L1's passes cost, and the rest of `events_back_to_back` is what fetching
the rows from L2 costs.

It prints one JSON line with the rounds, the median of each clock over
the rounds, `K5_hot_ms`, host ms of the K5 chain (candidates and refine, 3 calls, each
ended by a device sync), and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import cuda_ms, timed, trace_kernel  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_window_kernel: needs a CUDA device", file=sys.stderr)
        return 2
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)  # the checkout under test, ahead of this one
    from linemod_pose_estimation_tpu_torch.models.detector import Detector
    from linemod_pose_estimation_tpu_torch.models.serving import BatchedMatcher
    from linemod_pose_estimation_tpu_torch.ops import _build
    from linemod_pose_estimation_tpu_torch.ops import cuda_kernels as CK
    from linemod_pose_estimation_tpu_torch.ops import match as M
    from linemod_pose_estimation_tpu_torch.utils import scenes as S

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _build.library()
    rgbs_np, deps_np, _ = S.bin_picking_batch(32, seed=3)
    rgbs, deps = torch.from_numpy(rgbs_np).to(dev), torch.from_numpy(deps_np).to(dev)
    det = Detector.read(os.path.join(repo, "data", "boxNew_rgbd_templates.yml.gz"), device=dev)
    cid = det.class_ids[0]
    bank = det.bank(cid)
    det.attach_bank(bank.tile(-(-10240 // bank.num_templates), 10624))
    m = BatchedMatcher(det, cid, 91.0, 32, top_k=128, device=dev)

    def chain():
        R0, cands, _ = m.candidates(rgbs, deps)
        return R0, cands, M.refine_candidates_pallas_batched(
            R0, m.feats0, cands, m.T1, 91.0, m.E0, fine_T=m.T0)

    R0, cands, _ = chain()  # warm-up
    plan = M.window_plan(R0.shape, m.feats0, cands, m.T1, m.E0, m.T0)
    run = lambda f=CK.refine_scores: f(R0, *plan.operands(), window=24,
                                       frame_idx=plan.frame_idx)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def singles(before=None, n=args.reps) -> list[float]:
        out = []
        for _ in range(n):
            if before is not None:
                before()
            torch.cuda.synchronize()
            start.record()
            run()
            stop.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(stop))
        return out

    rounds = []
    for _ in range(args.rounds):
        parts, counts = trace_kernel(run, "refine_scores_kernel", args.reps)
        launches = sum(counts.values())
        one = singles()
        rounds.append(dict(
            profiler=sum(parts.values()) / args.reps, trace_launches=launches,
            events_back_to_back=cuda_ms(run, args.reps),
            events_single=float(np.median(one)), events_single_min=min(one),
            events_single_flushed=float(np.median(singles(scratch.zero_))),
            events_single_after_plain=float(np.median(
                singles(lambda: run(CK.refine_scores_plain), 3))),
            events_single_after_idle=float(np.median(singles(lambda: time.sleep(0.2), 5)))))
    clocks = [k for k in rounds[0] if k != "trace_launches"]
    median = {k: float(np.median([r[k] for r in rounds])) for k in clocks}
    hot = plan._replace(oris=torch.zeros_like(plan.oris), dys=torch.zeros_like(plan.dys),
                        dxs=torch.zeros_like(plan.dxs))
    hot_ms = cuda_ms(lambda: CK.refine_scores(R0, *hot.operands(), window=24,
                                              frame_idx=hot.frame_idx), args.reps)
    out = dict(repo=repo, card=card, K5_hot_ms=hot_ms, candidates=int(plan.nf.numel()),
               live_features=int(plan.nf.sum()), reps=args.reps, K5_ms=median,
               trace_launches=[r["trace_launches"] for r in rounds], rounds=rounds,
               chain_ms=timed(chain, 3))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
