"""Write tests/data/torch_sharded_golden.npz: the JAX reference's multi-device
layer (parallel/sharded_match.py) at full width, for the PyTorch port's
CPU test (tests/test_torch_sharded_golden.py) and phase 14 of chip_smoke.py,
which read only this file and so need no JAX.

The frames are those of tests/data/torch_cascade_golden.npz (four 640x480
RGB-D frames: the cuboid at templates 0, 1400 and 2000, and a background
frame); the bank is the untiled 2652-template RGB-D bank; threshold 91,
top_k 128.  The reference runs on 4 virtual CPU devices:

- `pool_*`: make_sharded_detect_step on a data=2 x bank=2 mesh in the
  pooled mode at serving.slice_settings scaled to 2 frames a device
  (pool_coarse 112, pool_fine 72, sel_row_cap 128, fine_g 4; the
  reference's step has no group tier): Matches (4, 128) as `pool_m_*` and
  the metrics as `pool_num_matches`, `pool_best_similarity`,
  `pool_prune_fallback_shards`;
- `pos_*`: the same step in the positions mode at its default caps;
- `row_m_*`: make_row_sharded_matcher over "bank" of that mesh (2 stripes
  of 240 level-0 rows) on frame 0's response maps: Matches (128,);
- `ring_m_*`: make_ring_detect_step on a 4-device ring, one frame a
  device: Matches (4, 128).

About two minutes on an 8-core host:

    python tools/make_torch_sharded_golden.py [--out PATH]
"""

from __future__ import annotations

import argparse
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    flags += " --xla_force_host_platform_device_count=4"
# The virtual devices timeshare the host's cores: a shard's full-width GEMM
# can reach the all-gather long after its peers, past XLA's default 40 s
# collective timeout (as in tools/make_sharding_report.py).
if "collective_call_terminate_timeout" not in flags:
    flags += (" --xla_cpu_collective_call_warn_stuck_timeout_seconds=300"
              " --xla_cpu_collective_call_terminate_timeout_seconds=1200")
os.environ["XLA_FLAGS"] = flags.strip()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANK = os.path.join(REPO, "data", "boxNew_rgbd_templates.yml.gz")
FRAMES = os.path.join(REPO, "tests", "data", "torch_cascade_golden.npz")
THRESHOLD = 91.0
TOP_K = 128
MESH = (2, 2)
POOL = dict(pool_coarse=56 * 2, pool_fine=36 * 2, sel_row_cap=128)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "tests", "data",
                                                  "torch_sharded_golden.npz"))
    args = ap.parse_args()
    sys.path.insert(0, REPO)

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    jax.config.update("jax_platforms", "cpu")
    from linemod_pose_estimation_tpu.models.detector import Detector
    from linemod_pose_estimation_tpu.ops import match as M
    from linemod_pose_estimation_tpu.parallel import sharded_match as SM

    with np.load(FRAMES) as z:
        rgbs, deps = z["rgb"], z["depth_mm"]
    det = Detector.read(BANK)
    bank = det.bank(det.class_ids[0])
    T0, T1 = det.params.t_pyramid
    Kc1, E0 = bank.max_cell_extent(1), bank.extent(0)
    C = 8 * bank.num_modalities
    feats1, feats0 = bank.merged_features(1), bank.merged_features(0)
    use_depth = det.params.use_depth_normal
    rec: dict[str, np.ndarray] = {"threshold": np.float32(THRESHOLD),
                                  "top_k": np.int32(TOP_K), "mesh": np.asarray(MESH),
                                  **{k: np.int32(v) for k, v in POOL.items()}}

    def put(prefix, record):
        for name, a in record._asdict().items():
            rec[prefix + name] = np.asarray(a)

    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(MESH), ("data", "bank"))
    data = lambda a: jax.device_put(jnp.asarray(a), NamedSharding(mesh, P("data")))
    sb = SM.make_sharded_bank(mesh, feats1, feats0, C=C, T1=T1, Kc1=Kc1)
    kw = dict(top_k=TOP_K, threshold=THRESHOLD, T0=T0, E0=E0, use_depth=use_depth)
    for key, mode in (("pool", dict(prune_mode="pooled", **POOL)),
                      ("pos", dict(prune_mode="positions"))):
        step = SM.make_sharded_detect_step(mesh, T1, Kc1, prune=True, **mode, **kw)
        m, metrics = step(data(rgbs), data(deps), sb)
        put(f"{key}_m_", m)
        for k, v in metrics.items():
            rec[f"{key}_{k}"] = np.asarray(v)
        print(key, int(np.asarray(m.valid).sum()), {k: np.asarray(v).item()
                                                    for k, v in metrics.items()}, flush=True)

    pyr = M.preprocess_frame(jnp.asarray(rgbs[0]), jnp.asarray(deps[0]), T0=T0, T1=T1,
                             use_depth=use_depth)
    R0, R1 = M.stack_modalities(pyr, use_depth)
    rows = lambda a: jax.device_put(a, NamedSharding(mesh, P(None, "bank")))
    rep = lambda a: jax.device_put(a, NamedSharding(mesh, P()))
    row = SM.make_row_sharded_matcher(mesh, "bank", T1, Kc1, top_k=TOP_K,
                                      threshold=THRESHOLD, T0=T0, E0=E0)
    m = row(rows(R1), rows(R0), rep(bank.gemm_weights(1)), jax.tree.map(rep, feats1),
            jax.tree.map(rep, feats0))
    put("row_m_", m)
    print("row", int(np.asarray(m.valid).sum()), flush=True)

    ring_mesh = Mesh(np.asarray(jax.devices()[:4]), ("ring",))
    ring = lambda a: jax.device_put(jnp.asarray(a), NamedSharding(ring_mesh, P("ring")))
    rb = SM.make_ring_bank(ring_mesh, "ring", feats1, feats0, C=C, T1=T1, Kc1=Kc1)
    step = SM.make_ring_detect_step(ring_mesh, "ring", T1, Kc1, **kw)
    m = step(ring(rgbs), ring(deps), rb)
    put("ring_m_", m)
    print("ring", int(np.asarray(m.valid).sum()), flush=True)
    np.savez_compressed(args.out, **rec)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
