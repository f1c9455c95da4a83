"""Write tests/data/torch_cascade_golden.npz: the JAX reference's answer of
the single-frame detection cascade (DetectionPipeline.detect, default
CascadeParams) at full width, against which the PyTorch port is held (the
slow CPU test in tests/test_torch_cascade.py and phase 6 of
chip_smoke.py, which reads only this file: the card's machine has no JAX).

The frames: the cuboid stand-in for the boxNew mesh
(linemod_pose_estimation_tpu_torch.utils.scenes.cuboid_mesh) rendered by
the reference's renderer at templates 0, 1400 and 2000 of the bank, with
the bank's intrinsics, at 640x480: the flat-shaded object on black, its
depth over a 1500 mm background; then one background-only frame.  The
bank: the 2652-template RGB-D bank and its params.  Threshold 91.

Stored: the frames' rgb (u8) and depth_mm (f32) (each package builds its
organized cloud from the depth with its own depth_to_cloud), every
Matches slot, the ClusterSet, the NMS keep mask and cluster order, and
every lane of the ClusterPose.

Runs the reference on the CPU (36 s on 8 cores, most of it the four
full-frame renders and the first detect's compile):

    python tools/make_torch_cascade_golden.py [--out PATH]
"""

from __future__ import annotations

import argparse
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANK = os.path.join(REPO, "data", "boxNew_rgbd_templates.yml.gz")
PARAMS = os.path.join(REPO, "data", "boxNew_rgbd_params.yml.gz")
TEMPLATES = (0, 1400, 2000)  # -1 marks the background-only frame
THRESHOLD = 91.0
BG_MM = 1500.0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "tests", "data",
                                                  "torch_cascade_golden.npz"))
    args = ap.parse_args()
    sys.path.insert(0, REPO)

    import jax
    import jax.numpy as jnp
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    from linemod_pose_estimation_tpu.models.cascade import CascadeParams
    from linemod_pose_estimation_tpu.models.detector import Detector
    from linemod_pose_estimation_tpu.models.pipeline import DetectionPipeline
    from linemod_pose_estimation_tpu.models.renderer import _pad_triangles, render
    from linemod_pose_estimation_tpu.models.templates import TemplateBank
    from linemod_pose_estimation_tpu.utils import pointcloud as pcu
    from linemod_pose_estimation_tpu_torch.utils.scenes import cuboid_mesh

    meta, glob = TemplateBank.read_params_yaml(PARAMS)
    W, H = glob.width, glob.height
    K = jnp.array([[glob.focal_length_x, 0, W / 2.0],
                   [0, glob.focal_length_y, H / 2.0], [0, 0, 1.0]], jnp.float32)
    mesh = cuboid_mesh()
    tris = jnp.asarray(_pad_triangles(mesh.triangles.astype(np.float32), 64))
    rgbs, deps = [], []
    for t in TEMPLATES:
        out = render(tris, jnp.asarray(meta.R[t], jnp.float32),
                     jnp.asarray(meta.T[t], jnp.float32), K, W, H)
        hit = np.asarray(out.mask) > 0
        rgbs.append(np.asarray(out.rgb))
        deps.append(np.where(hit, np.asarray(out.depth_mm), BG_MM).astype(np.float32))
    rgbs.append(np.zeros((H, W, 3), np.uint8))
    deps.append(np.full((H, W), BG_MM, np.float32))

    pipe = DetectionPipeline(Detector.read(BANK), meta, glob, mesh, CascadeParams())
    rec: dict[str, list] = {}
    for rgb, dep in zip(rgbs, deps):
        cloud = pcu.depth_to_cloud(jnp.asarray(dep) / 1000.0, K)
        dets, st = pipe.detect(rgb, np.asarray(cloud), threshold=THRESHOLD,
                               depth_mm=dep, return_stages=True)
        for group, nt in (("m", st.matches), ("c", st.clusters), ("p", st.poses)):
            for name, a in nt._asdict().items():
                rec.setdefault(f"{group}_{name}", []).append(np.asarray(a))
        rec.setdefault("nms_keep", []).append(st.nms_keep)
        rec.setdefault("cluster_order", []).append(st.cluster_order)
        print(f"frame: {int(np.asarray(st.matches.valid).sum())} valid matches, "
              f"{len(dets)} detections", flush=True)
    np.savez_compressed(
        args.out, rgb=np.stack(rgbs), depth_mm=np.stack(deps),
        templates=np.array(TEMPLATES + (-1,), np.int32), threshold=THRESHOLD,
        **{k: np.stack(v) for k, v in rec.items()})
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")


if __name__ == "__main__":
    main()
