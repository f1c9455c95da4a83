"""Write tests/data/torch_cascade_golden.npz and
tests/data/torch_cascade_options_golden.npz: the JAX reference's answers of
the single-frame detection cascade (DetectionPipeline.detect) at full
width, with default CascadeParams and with the non-default configurations
of ``models.cascade.GOLDEN_OPTION_SETS``, against which the PyTorch port
is held (the slow CPU tests in tests/test_torch_cascade.py and phases 6
and 10 of chip_smoke.py, which read only these files: the card's machine
has no JAX).

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

The options file reuses the first file's frames and stores outputs only,
per configuration `name` and over that configuration's frames
(`<name>_frames`): `<name>_c_*` the ClusterSet, `<name>_nms_keep`,
`<name>_cluster_order`, `<name>_p_*` every lane of the ClusterPose.  The
Matches do not depend on the cascade's options: they are the first
file's.

Runs the reference on the CPU (the first file: 36 s on 8 cores, most of
it the four full-frame renders and the first detect's compile; the
options file: one compile of the pose stage per configuration):

    python tools/make_torch_cascade_golden.py [--which base|options|both]
                                              [--out PATH] [--options-out PATH]
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
    ap.add_argument("--options-out", default=os.path.join(
        REPO, "tests", "data", "torch_cascade_options_golden.npz"))
    ap.add_argument("--which", choices=("base", "options", "both"), default="both")
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
    from linemod_pose_estimation_tpu_torch.models.cascade import GOLDEN_OPTION_SETS
    from linemod_pose_estimation_tpu_torch.utils.scenes import cuboid_mesh

    meta, glob = TemplateBank.read_params_yaml(PARAMS)
    W, H = glob.width, glob.height
    K = jnp.array([[glob.focal_length_x, 0, W / 2.0],
                   [0, glob.focal_length_y, H / 2.0], [0, 0, 1.0]], jnp.float32)
    mesh = cuboid_mesh()
    tris = jnp.asarray(_pad_triangles(mesh.triangles.astype(np.float32), 64))
    detector = Detector.read(BANK)

    def run(params, rgb, dep, rec, groups):
        cloud = pcu.depth_to_cloud(jnp.asarray(dep) / 1000.0, K)
        dets, st = DETECT[params](rgb, np.asarray(cloud), threshold=THRESHOLD,
                                  depth_mm=dep, return_stages=True)
        for group, nt in zip("mcp", (st.matches, st.clusters, st.poses)):
            if group in groups:
                for name, a in nt._asdict().items():
                    rec.setdefault(f"{group}_{name}", []).append(np.asarray(a))
        rec.setdefault("nms_keep", []).append(st.nms_keep)
        rec.setdefault("cluster_order", []).append(st.cluster_order)
        print(f"frame: {int(np.asarray(st.matches.valid).sum())} valid matches, "
              f"{len(dets)} detections", flush=True)

    class _Pipes(dict):  # one pipeline (one compile) per configuration
        def __missing__(self, key):
            self[key] = DetectionPipeline(detector, meta, glob, mesh,
                                          CascadeParams(**dict(key))).detect
            return self[key]

    DETECT = _Pipes()

    if args.which in ("base", "both"):
        rgbs, deps = [], []
        for t in TEMPLATES:
            out = render(tris, jnp.asarray(meta.R[t], jnp.float32),
                         jnp.asarray(meta.T[t], jnp.float32), K, W, H)
            hit = np.asarray(out.mask) > 0
            rgbs.append(np.asarray(out.rgb))
            deps.append(np.where(hit, np.asarray(out.depth_mm), BG_MM).astype(np.float32))
        rgbs.append(np.zeros((H, W, 3), np.uint8))
        deps.append(np.full((H, W), BG_MM, np.float32))
        rec: dict[str, list] = {}
        for rgb, dep in zip(rgbs, deps):
            run((), rgb, dep, rec, "mcp")
        np.savez_compressed(
            args.out, rgb=np.stack(rgbs), depth_mm=np.stack(deps),
            templates=np.array(TEMPLATES + (-1,), np.int32), threshold=THRESHOLD,
            **{k: np.stack(v) for k, v in rec.items()})
        print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")

    if args.which in ("options", "both"):
        with np.load(args.out) as z:
            rgbs, deps = z["rgb"], z["depth_mm"]
        store = {}
        for cfg, (options, frames) in GOLDEN_OPTION_SETS.items():
            print(f"{cfg}: {options}", flush=True)
            rec = {}
            for f in frames:
                run(tuple(sorted(options.items())), rgbs[f], deps[f], rec, "cp")
            store[f"{cfg}_frames"] = np.array(frames, np.int32)
            store.update({f"{cfg}_{k}": np.stack(v) for k, v in rec.items()})
            DETECT.clear()
        np.savez_compressed(args.options_out, threshold=THRESHOLD, **store)
        print(f"wrote {args.options_out} ({os.path.getsize(args.options_out)} bytes)")


if __name__ == "__main__":
    main()
