"""Write tests/data/torch_window_golden.npz: the JAX reference's answers on
the frames of tests/data/torch_cascade_golden.npz (four 640x480 RGB-D
frames: the cuboid at templates 0, 1400 and 2000 of the bank, and a
background-only frame) for three paths of the PyTorch port, which is held
against them (the slow CPU tests in tests/test_torch_exhaustive.py and
tests/test_torch_multiclass.py, and phases 7-8 of chip_smoke.py, which
read only this file: the card's machine has no JAX).

- `x_*`: the exhaustive BatchedMatcher (the class's default, prune=False;
  top_k 128) over the 2652-template RGB-D bank at threshold 91: Matches
  (4, 128).
- `k5_*`: the K5 chain on the same candidates — the window refiner,
  here refine_candidates_slices (the Pallas kernel's interpret mode is
  too slow at K = 512; the reference states, and the port's tests check,
  that its window refiners agree): Matches (4, 128).
- `fn_*`: Detector.make_matcher_fn(threshold 91, top_k 512) on frame 0:
  Matches (512,).
- `mc{0,1}_*`, `mc_stats_*`: MultiClassBatchedMatcher(prune_mode=
  "pooled") with the bank under two class ids at thresholds 92 / 94, the
  bench's two-object pools (56 B coarse, 36 B fine), top_k 128, B=4: each
  class's Matches (4, 128) and the PooledStats.

The exhaustive passes run one frame at a time (the frames do not
interact there) to bound the host memory of the full GEMM.  Runs the
reference on the CPU:

    python tools/make_torch_window_golden.py [--out PATH]
"""

from __future__ import annotations

import argparse
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANK = os.path.join(REPO, "data", "boxNew_rgbd_templates.yml.gz")
FRAMES = os.path.join(REPO, "tests", "data", "torch_cascade_golden.npz")
THRESHOLD = 91.0
TOP_K = 128
TWO_OBJECT_THRESHOLDS = (92.0, 94.0)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "tests", "data",
                                                  "torch_window_golden.npz"))
    args = ap.parse_args()
    sys.path.insert(0, REPO)

    import jax
    import jax.numpy as jnp
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    from linemod_pose_estimation_tpu.models.detector import Detector
    from linemod_pose_estimation_tpu.models.serving import (
        BatchedMatcher, MultiClassBatchedMatcher)
    from linemod_pose_estimation_tpu.models.templates import TemplateBank
    from linemod_pose_estimation_tpu.ops import match as M

    with np.load(FRAMES) as z:
        rgbs, deps = z["rgb"], z["depth_mm"]
    det = Detector.read(BANK)
    cid = det.class_ids[0]
    rec: dict[str, np.ndarray] = {}

    def put(prefix, m):
        for name, a in m._asdict().items():
            rec[prefix + name] = np.asarray(a)

    # exhaustive match_batch and the K5 chain, frame by frame
    bm = BatchedMatcher(det, cid, THRESHOLD, 1, top_k=TOP_K)
    xs, k5s = [], []
    for b in range(rgbs.shape[0]):
        r, d = jnp.asarray(rgbs[b:b + 1]), jnp.asarray(deps[b:b + 1])
        xs.append(bm.match_batch(r, d))
        R0, R1 = bm._pre(r, d)
        Hc, Wc = R1.shape[2] // bm.T1, R1.shape[3] // bm.T1
        cand = bm._sel(bm._coarse(R1, bm.W1), bm.feats1, Hc, Wc)
        k5s.append(M.refine_candidates_slices(
            R0[0], bm.feats0, M.CoarseMatches(*(a[0] for a in cand)), bm.T1,
            THRESHOLD, bm.E0, fine_T=bm.T0))
        print(f"frame {b}: {int(np.asarray(xs[-1].valid).sum())} exhaustive, "
              f"{int(np.asarray(k5s[-1].valid).sum())} K5-chain valid matches", flush=True)
    put("x_", M.Matches(*(np.concatenate([np.asarray(a) for a in f]) for f in zip(*xs))))
    put("k5_", M.Matches(*(np.stack([np.asarray(a) for a in f]) for f in zip(*k5s))))

    fn = det.make_matcher_fn(cid, THRESHOLD)
    put("fn_", fn(rgbs[0], jnp.asarray(deps[0])))

    # the two-object configuration: the bank under two class ids
    bank = det.bank(cid)
    cid2 = cid + "_second"
    det.attach_bank(TemplateBank(cid2, bank.params, bank.templates))
    B = rgbs.shape[0]
    mc = MultiClassBatchedMatcher(det, [cid, cid2], list(TWO_OBJECT_THRESHOLDS), B,
                                  top_k=TOP_K, prune_mode="pooled",
                                  pool_coarse=56 * B, pool_fine=36 * B)
    out = mc.match_batch(jnp.asarray(rgbs), jnp.asarray(deps))
    for i, c in enumerate((cid, cid2)):
        put(f"mc{i}_", out[c])
    put("mc_stats_", mc.last_pool)
    print(f"two-object: {[int(np.asarray(out[c].valid).sum()) for c in (cid, cid2)]} "
          f"valid, fallback {bool(mc.last_pool.fallback)}", flush=True)

    np.savez_compressed(args.out, threshold=THRESHOLD, top_k=TOP_K,
                        two_object_thresholds=np.array(TWO_OBJECT_THRESHOLDS), **rec)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")


if __name__ == "__main__":
    main()
