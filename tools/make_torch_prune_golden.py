"""Write tests/data/torch_prune_golden.npz: the JAX reference's answers, at
full width, for the per-frame-cap prune modes of the PyTorch port, which is
held against them (the slow CPU test in tests/test_torch_prune_serving.py
and phase 9 of chip_smoke.py, which read only this file and so need no
JAX).

The frames are those of tests/data/torch_cascade_golden.npz (four 640x480
RGB-D frames: the cuboid at templates 0, 1400 and 2000 of the bank, and a
background-only frame); the bank is the 2652-template RGB-D bank; threshold
91, top_k 128.  Each entry holds the Matches and the plan records only:

- `pos_*`: BatchedMatcher(prune=True), the default `positions` mode at its
  default caps (256 coarse, 128 fine a frame): `pos_m_*` Matches (4, 128),
  `pos_pp_*` the PrunePlan, `pos_fp_*` the FinePlan;
- `fof_*`: the same with fine_pos_cap FINE_OVERFLOW_CAP, which the fine
  survivors overflow (the coarse survivor set is scored);
- `cof_*`: the same with prune_pos_cap COARSE_OVERFLOW_CAP, which the
  coarse survivors overflow (the exhaustive GEMM runs);
- `two_*`: prune_mode="two_axis" at its default caps: `two_m_*`, `two_pp_*`;
- `mc{0,1}_m_*`, `mc_pp_*`: MultiClassBatchedMatcher in its default mode
  with the bank under two class ids at thresholds 92 / 94.

Runs the reference on the CPU (about a minute):

    python tools/make_torch_prune_golden.py [--out PATH]
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
FINE_OVERFLOW_CAP = 2
COARSE_OVERFLOW_CAP = 4
TWO_OBJECT_THRESHOLDS = (92.0, 94.0)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "tests", "data",
                                                  "torch_prune_golden.npz"))
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

    with np.load(FRAMES) as z:
        rgbs, deps = jnp.asarray(z["rgb"]), jnp.asarray(z["depth_mm"])
    B = rgbs.shape[0]
    det = Detector.read(BANK)
    cid = det.class_ids[0]
    rec: dict[str, np.ndarray] = {}

    def put(prefix, record):
        for name, a in record._asdict().items():
            rec[prefix + name] = np.asarray(a)

    settings = {"pos": {}, "fof": dict(fine_pos_cap=FINE_OVERFLOW_CAP),
                "cof": dict(prune_pos_cap=COARSE_OVERFLOW_CAP),
                "two": dict(prune_mode="two_axis")}
    for key, kw in settings.items():
        bm = BatchedMatcher(det, cid, THRESHOLD, B, top_k=TOP_K, prune=True, **kw)
        m = bm.match_batch(rgbs, deps)
        put(f"{key}_m_", m)
        put(f"{key}_pp_", bm.last_prune)
        if bm.last_fine is not None:
            put(f"{key}_fp_", bm.last_fine)
        print(f"{key}: {int(np.asarray(m.valid).sum())} valid matches, survivors "
              f"{np.asarray(bm.last_prune.m_survivors).tolist()}, overflow "
              f"{bool(bm.last_prune.overflow)}, fine "
              f"{None if bm.last_fine is None else (np.asarray(bm.last_fine.m_survivors).tolist(), bool(bm.last_fine.overflow))}",
              flush=True)
    assert not rec["pos_pp_overflow"] and not rec["pos_fp_overflow"]
    assert not rec["fof_pp_overflow"] and rec["fof_fp_overflow"]
    assert rec["cof_pp_overflow"] and not rec["two_pp_overflow"]

    bank = det.bank(cid)
    cid2 = cid + "_second"
    det.attach_bank(TemplateBank(cid2, bank.params, bank.templates))
    mc = MultiClassBatchedMatcher(det, [cid, cid2], list(TWO_OBJECT_THRESHOLDS), B,
                                  top_k=TOP_K)
    out = mc.match_batch(rgbs, deps)
    for i, c in enumerate((cid, cid2)):
        put(f"mc{i}_m_", out[c])
    put("mc_pp_", mc.last_prune)
    print(f"two-object: {[int(np.asarray(out[c].valid).sum()) for c in (cid, cid2)]} "
          f"valid, overflow {bool(mc.last_prune.overflow)}", flush=True)

    np.savez_compressed(
        args.out, threshold=THRESHOLD, top_k=TOP_K,
        fine_overflow_cap=FINE_OVERFLOW_CAP, coarse_overflow_cap=COARSE_OVERFLOW_CAP,
        two_object_thresholds=np.array(TWO_OBJECT_THRESHOLDS), **rec)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")


if __name__ == "__main__":
    main()
