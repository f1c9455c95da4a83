"""Write tests/data/torch_port_golden.npz: the JAX reference's answer on the
8-frame check batch, against which the PyTorch port is held (the slow CPU
test in tests/test_torch_slice.py and phase 2a of chip_smoke.py).

The batch: each committed 640x480 render planted once, shifted by a fixed
seed, on a bin-picking background, plus one background-only frame
(linemod_pose_estimation_tpu_torch.utils.scenes.golden_batch).  The bank:
the untiled 2652-template RGB-D bank.  The settings: the production pooled
path at B=8 (models.serving.slice_settings), threshold 91.  Stored: every
Matches slot, the select's per-frame valid counts (n_valid), the
PooledStats, and per-frame sha256 of the R0 / R1 response stacks.

Runs the reference on the CPU (about a minute):

    python tools/make_torch_port_golden.py [--seed 0] [--out PATH]
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANK = os.path.join(REPO, "data", "boxNew_rgbd_templates.yml.gz")
THRESHOLD = 91.0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(REPO, "tests", "data",
                                                  "torch_port_golden.npz"))
    args = ap.parse_args()
    sys.path.insert(0, REPO)

    import jax
    import jax.numpy as jnp
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    from linemod_pose_estimation_tpu.models.detector import Detector
    from linemod_pose_estimation_tpu.models.serving import BatchedMatcher
    from linemod_pose_estimation_tpu_torch.models.serving import slice_settings
    from linemod_pose_estimation_tpu_torch.utils.scenes import golden_batch

    rgbs, deps, _ = golden_batch(args.seed)
    B, H, W = deps.shape
    det = Detector.read(BANK)
    cid = det.class_ids[0]
    jm = BatchedMatcher(det, cid, THRESHOLD, B, **slice_settings(B, H, W))
    R0, R1 = jm._pre(jnp.asarray(rgbs), jnp.asarray(deps))
    Hc, Wc = R1.shape[2] // jm.T1, R1.shape[3] // jm.T1
    cands, n_valid, stats = jm._match_pool(
        R1, jm.W1, jm.W_cell, jm.W_fine, jm.feats1, Hc, Wc)
    m = jm._refine_nv(R0, cands, jm.feats0, n_valid)
    # the staged calls are exactly what match_batch runs
    full = jm.match_batch(jnp.asarray(rgbs), jnp.asarray(deps))
    for a, b in zip(m, full):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    sha = lambda R: np.array([hashlib.sha256(np.asarray(R[b]).tobytes()).hexdigest()
                              for b in range(B)])
    out = dict(
        seed=np.int64(args.seed), threshold=np.float64(THRESHOLD),
        n_valid=np.asarray(n_valid), r0_sha256=sha(R0), r1_sha256=sha(R1),
        **{name: np.asarray(a) for name, a in zip(m._fields, m)},
        **{"stats_" + name: np.asarray(a) for name, a in zip(stats._fields, stats)},
    )
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out}: n_valid {out['n_valid'].tolist()}, valid matches "
          f"{int(out['valid'].sum())}, fallback {bool(out['stats_fallback'])}")


if __name__ == "__main__":
    main()
