"""Time kernels K3 (the walk) and K4 (the z-buffer) of one checkout of the
port on one NVIDIA GPU, at the shapes its paths launch them, with the
B=32 batch and one detect around them.

    python tools/time_walk_raster_kernels.py [--repo DIR] [--reps 50]

`--repo` is the root of a checkout (default: this one), so two commits
compare on one card by running the script once per checkout, in turns
(parent, change, change, parent).  It uses only calls that every version
of the port has: `match.walk_plan`, `cuda_kernels.walk_scores`,
`raster.triangle_coefficients`, `raster.raster_zbuffer`,
`BatchedMatcher` and `DetectionPipeline`.

It prints one JSON line with:
- K3's times per launch (chip_smoke.kernel_times: the device time by
  torch.profiler over `--reps` launches after a warm-up, and the CUDA-event
  time a call) on the B=32 batch's walk plan (chip_smoke phase 2b's scenes
  and tiled bank, the walked slots only) and on the operands detect
  passes it (cascade golden frame 0: B=1, 512 slots);
- K4's times per call the same way (its three kernels in all and each)
  on the cuboid at 8 bank poses in the 256x256 viewport, at the first 4
  of them, and on the operands detect passes it;
- host ms of detect on golden frame 0 (10 calls, each ended by a device
  sync) and of the B=32 pooled batch (5 calls), after a warm-up;
- the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import first_calls, kernel_times, timed  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_walk_raster_kernels: needs a CUDA device", file=sys.stderr)
        return 2
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)  # the checkout under test, ahead of this one
    from linemod_pose_estimation_tpu_torch.models.detector import Detector
    from linemod_pose_estimation_tpu_torch.models.pipeline import DetectionPipeline
    from linemod_pose_estimation_tpu_torch.models.renderer import _pad_triangles
    from linemod_pose_estimation_tpu_torch.models.serving import BatchedMatcher, slice_settings
    from linemod_pose_estimation_tpu_torch.models.templates import TemplateBank
    from linemod_pose_estimation_tpu_torch.ops import _build
    from linemod_pose_estimation_tpu_torch.ops import cuda_kernels as CK
    from linemod_pose_estimation_tpu_torch.ops import match as M
    from linemod_pose_estimation_tpu_torch.ops import raster as RA
    from linemod_pose_estimation_tpu_torch.utils import pointcloud as TP
    from linemod_pose_estimation_tpu_torch.utils import scenes as S

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _build.library()
    bank_path = os.path.join(repo, "data", "boxNew_rgbd_templates.yml.gz")
    params_path = os.path.join(repo, "data", "boxNew_rgbd_params.yml.gz")
    out = dict(repo=repo, card=card)

    # K4 on the cuboid at bank poses in the cascade's 256x256 viewport.
    meta, glob = TemplateBank.read_params_yaml(params_path)
    tris = torch.from_numpy(_pad_triangles(S.cuboid_mesh().triangles, 64)).to(dev)
    K = torch.tensor([[glob.focal_length_x, 0, 128.0], [0, glob.focal_length_y, 128.0],
                      [0, 0, 1]], dtype=torch.float32, device=dev)
    ids = [0, 300, 700, 1000, 1400, 1700, 2000, 2400]
    k4 = {}
    for name, sel in (("cascade_8x256x256", ids), ("detect_4x256x256", ids[:4])):
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        coefs = RA.triangle_coefficients(tris, f32(meta.R[sel]), f32(meta.T[sel]),
                                         K.expand(len(sel), 3, 3))
        k4[name] = kernel_times(lambda c=coefs: RA.raster_zbuffer(c, 256, 256),
                                "raster_zbuffer", args.reps, 3)

    # detect on cascade golden frame 0, and the operands it passes K3 and K4.
    with np.load(os.path.join(repo, "tests", "data", "torch_cascade_golden.npz")) as z:
        rgb, depth, thr = z["rgb"][0], z["depth_mm"][0], float(z["threshold"])
    pipe = DetectionPipeline.from_files(bank_path, params_path, S.cuboid_mesh(), device=dev)
    d = torch.from_numpy(depth).to(dev)
    cloud = TP.depth_to_cloud(TP.true_div(d, 1000.0), pipe.K_render)
    detect = lambda: pipe.detect(rgb, cloud, threshold=thr, depth_mm=d)
    detect()  # warm-up
    got = first_calls([(CK, "walk_scores"), (RA, "raster_zbuffer")], detect)
    k4["detect_captured"] = kernel_times(lambda: RA.raster_zbuffer(*got["raster_zbuffer"]),
                                         "raster_zbuffer", args.reps, 3)
    k3 = {"detect_B1": kernel_times(lambda: CK.walk_scores(*got["walk_scores"]),
                                    "walk_scores", args.reps)}
    out["detect_ms"] = timed(detect, 10)

    # The B=32 batch over the tiled bank (chip_smoke phase 2b) and its walk.
    rgbs_np, deps_np, _ = S.bin_picking_batch(32, seed=3)
    rgbs, deps = torch.from_numpy(rgbs_np).to(dev), torch.from_numpy(deps_np).to(dev)
    det = Detector.read(bank_path, device=dev)
    cid = det.class_ids[0]
    bank = det.bank(cid)
    det.attach_bank(bank.tile(-(-10240 // bank.num_templates), 10624))
    m = BatchedMatcher(det, cid, 91.0, 32, device=dev, **slice_settings(32))
    R0, cands, n_valid = m.candidates(rgbs, deps)
    plan = M.walk_plan(R0.shape, m.feats0, cands, m.T1, m.E0, m.T0, n_valid=n_valid)
    k3["valid_prefix"] = kernel_times(lambda: CK.walk_scores(R0, *plan.operands(), m.T0),
                                      "walk_scores", args.reps)
    m.match_batch(rgbs, deps)  # warm-up
    out["batch_ms"] = timed(lambda: m.match_batch(rgbs, deps), 5)
    out.update(K3=k3, K4=k4,
               detect_ms_median=float(np.median(out["detect_ms"])),
               batch_ms_median=float(np.median(out["batch_ms"])))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
