"""Write tests/data/torch_serving_golden.npz: the JAX reference's answers
of the serving surface — PoseService, the detections it is built on,
look_at_point and template_refinement — on the four frames of
tests/data/torch_cascade_golden.npz, against which the PyTorch port's
service, nodes and CLI are held on the card (chip_smoke.py phase 11, which
reads only this file and the cascade golden: the card's machine has no
JAX).

The frames go in as the service, the nodes and the CLI take them:
Frame(rgb, cloud), no depth image, so the match scores colour only.  The
RGB-D bank scores nothing on colour alone (no valid match at any
threshold down to 50 on these frames), so the bank is the RGB-only one,
data/boxNew_full_*.yml.gz (the same 2652 views and params; the Ensenso
nodes' kind of bank), with the cuboid stand-in for the boxNew mesh,
default CascadeParams and threshold 91.  Each package builds the frames'
clouds from the cascade golden's depth the same way: the port's
depth_to_cloud on the CPU at the bank's intrinsics
(utils.scenes.replay_clouds), here too.

Stored (outputs only; D = the most detections of a frame, rows past a
frame's `det_n` are zero): `base_tool0` (the robot pose the service is
given), `threshold`, `unknown_id`; per frame `det_n`, `det_rect` (4, D,
4), `det_score`, `det_pose` (4, D, 4, 4), `look_at` (4, D, 3) at each
detection's rect, `refined_pose` (4, D, 4, 4) and `refined_fitness` from
template_refinement at each detection's pose and rect; `svc_translation`
(4, 3) and `svc_rotation` (4, 4) (x, y, z, w) of
PoseService.linemod_object_pose(0) with the frame source on that frame;
`unknown_translation` / `unknown_rotation` for an unregistered id.

Runs the reference on the CPU (about 1 minute on 8 cores):

    python tools/make_torch_serving_golden.py [--out PATH]
"""

from __future__ import annotations

import argparse
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANK = os.path.join(REPO, "data", "boxNew_full_templates.yml.gz")
PARAMS = os.path.join(REPO, "data", "boxNew_full_params.yml.gz")
CASCADE_GOLDEN = os.path.join(REPO, "tests", "data", "torch_cascade_golden.npz")
THRESHOLD = 91.0
UNKNOWN_ID = 7
# A robot pose (base <- tool0): 0.4 m ahead, 0.9 m up, turned about a tilted axis.
BASE_TOOL0 = (0.4, -0.2, 0.9, 0.8, 0.2, -0.1, 0.55)  # x, y, z, qw, qx, qy, qz


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "tests", "data",
                                                  "torch_serving_golden.npz"))
    args = ap.parse_args()
    sys.path.insert(0, REPO)

    import jax
    import jax.numpy as jnp
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    from linemod_pose_estimation_tpu.api import transforms as TR
    from linemod_pose_estimation_tpu.api.service import Frame, ObjectConfig, PoseService
    from linemod_pose_estimation_tpu.models.cascade import CascadeParams
    from linemod_pose_estimation_tpu.models.detector import Detector
    from linemod_pose_estimation_tpu.models.pipeline import DetectionPipeline
    from linemod_pose_estimation_tpu.models.serving import look_at_point, template_refinement
    from linemod_pose_estimation_tpu.models.templates import TemplateBank
    from linemod_pose_estimation_tpu_torch.utils.scenes import cuboid_mesh, replay_clouds

    meta, glob = TemplateBank.read_params_yaml(PARAMS)
    pipe = DetectionPipeline(Detector.read(BANK), meta, glob, cuboid_mesh(), CascadeParams())
    with np.load(CASCADE_GOLDEN) as z:
        rgbs, depths = z["rgb"], z["depth_mm"]
    clouds = replay_clouds(depths, glob.focal_length_x, glob.focal_length_y)
    frames = [Frame(rgb=r, cloud=c) for r, c in zip(rgbs, clouds)]
    base_tool0 = TR.make_affine(*BASE_TOOL0)
    current = {"f": 0}
    svc = PoseService(lambda: frames[current["f"]], base_tool0_source=lambda: base_tool0)
    svc.register_object(0, ObjectConfig(pipeline=pipe, threshold=THRESHOLD))

    rec = {k: [] for k in ("det_n", "det_rect", "det_score", "det_pose", "look_at",
                           "refined_pose", "refined_fitness", "svc_translation",
                           "svc_rotation")}
    for f, fr in enumerate(frames):
        dets = pipe.detect(fr.rgb, fr.cloud, THRESHOLD)
        cloud = jnp.asarray(fr.cloud)
        rec["det_n"].append(len(dets))
        rec["det_rect"].append([d.rect for d in dets])
        rec["det_score"].append([d.score for d in dets])
        rec["det_pose"].append([np.asarray(d.pose) for d in dets])
        rec["look_at"].append([np.asarray(look_at_point(cloud, d.rect)) for d in dets])
        refined = [template_refinement(jnp.asarray(d.pose), cloud, d.rect, pipe.triangles,
                                       pipe.K_render, pipe.render_wh) for d in dets]
        rec["refined_pose"].append([np.asarray(p) for p, _ in refined])
        rec["refined_fitness"].append([float(q) for _, q in refined])
        current["f"] = f
        t = svc.linemod_object_pose(0)
        rec["svc_translation"].append(t.translation)
        rec["svc_rotation"].append(t.rotation)
        print(f"frame {f}: {len(dets)} detections, rects {[d.rect for d in dets]}, "
              f"service {t}", flush=True)
    unknown = svc.linemod_object_pose(UNKNOWN_ID)

    D = max(1, max(rec["det_n"]))

    def pad(rows, shape, dtype):
        out = np.zeros((len(rows), D) + shape, dtype)
        for i, r in enumerate(rows):
            for j, v in enumerate(r):
                out[i, j] = v
        return out

    np.savez_compressed(
        args.out, base_tool0=base_tool0, threshold=THRESHOLD, unknown_id=UNKNOWN_ID,
        det_n=np.array(rec["det_n"], np.int32),
        det_rect=pad(rec["det_rect"], (4,), np.int32),
        det_score=pad(rec["det_score"], (), np.float32),
        det_pose=pad(rec["det_pose"], (4, 4), np.float32),
        look_at=pad(rec["look_at"], (3,), np.float32),
        refined_pose=pad(rec["refined_pose"], (4, 4), np.float32),
        refined_fitness=pad(rec["refined_fitness"], (), np.float32),
        svc_translation=np.array(rec["svc_translation"], np.float64),
        svc_rotation=np.array(rec["svc_rotation"], np.float64),
        unknown_translation=np.array(unknown.translation, np.float64),
        unknown_rotation=np.array(unknown.rotation, np.float64))
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")


if __name__ == "__main__":
    main()
