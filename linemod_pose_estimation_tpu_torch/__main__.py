"""Executable entry points: ``python -m linemod_pose_estimation_tpu_torch <cmd>``
— the port of ``linemod_pose_estimation_tpu/__main__.py``, with the same
commands, arguments, defaults and JSON lines:

  train    STL -> templates.yml + renderer_params.yml (renderer_node; one
           progress line a chunk, then one JSON line)
  detect   banks + replay frames -> one detections JSON line per frame
  serve    object registry + frame source -> pose RPC (object_id requests
           on stdin, one base-frame Transform JSON line each, identity on a
           miss or an unknown id)

Each takes ``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch
versions on the host).  ``detect`` and ``serve`` read banks by the native
loader, which is built with g++ on first use; they fail if it cannot build
rather than fall back to the much slower PyYAML reader.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _add_trainer_args(p: argparse.ArgumentParser) -> None:
    # The original renderer's defaults (its launch file's values).
    p.add_argument("stl", help="CAD mesh (.stl, ASCII or binary)")
    p.add_argument("--templates-out", required=True, help="templates.yml path")
    p.add_argument("--params-out", required=True, help="renderer_params.yml path")
    p.add_argument("--class-id", default="obj")
    p.add_argument("--n-points", type=int, default=150)
    p.add_argument("--angle-step", type=int, default=10)
    p.add_argument("--radius-min", type=float, default=0.5)
    p.add_argument("--radius-max", type=float, default=1.0)
    p.add_argument("--radius-step", type=float, default=0.1)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--fx", type=float, default=535.566011)
    p.add_argument("--fy", type=float, default=537.168115)
    p.add_argument("--near", type=float, default=0.1)
    p.add_argument("--far", type=float, default=1000.0)
    p.add_argument("--rgb-depth", action="store_true",
                   help="train ColorGradient + DepthNormal (renderer_node); default is "
                        "RGB-only (renderer_only_image_node, used for the Ensenso banks)")
    p.add_argument("--max-views", type=int, default=None,
                   help="cap the view count (smoke runs)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the renders and quantizers (default cuda)")


def _cascade_args(p: argparse.ArgumentParser) -> None:
    # The reference launch files' values (start_object_detection.launch).
    p.add_argument("--threshold", type=float, default=92.0)
    p.add_argument("--icp-max-iter", type=int, default=150)
    p.add_argument("--icp-tr-epsilon", type=float, default=1e-5)
    p.add_argument("--icp-ransac-thresh", type=float, default=0.02)
    p.add_argument("--icp-max-corr-dist", type=float, default=0.05)
    p.add_argument("--clustering-step", type=int, default=20)
    p.add_argument("--orientation-clustering-th", type=float, default=10.0)
    p.add_argument("--cluster-filter-thresh", type=int, default=2)
    p.add_argument("--bias-x", type=int, default=0,
                   help="Ensenso 752->640 crop offset")
    p.add_argument("--canonicalize", choices=["x_front", "z_down", "none"],
                   default="x_front")
    p.add_argument("--icp-variant", choices=["two_stage", "nonlinear", "point_to_plane"],
                   default="two_stage",
                   help="icpPoseRefine vs icpNonLinearPoseRefine (LM) vs the "
                        "point-to-plane accuracy variant")
    p.add_argument("--accuracy", action="store_true",
                   help="point-to-plane ICP, two orientation hypotheses per "
                        "cluster and pose-aware NMS")
    # Capacities (CascadeParams); smaller values run faster on small scenes.
    p.add_argument("--max-clusters", type=int, default=4)
    p.add_argument("--model-cap", type=int, default=1024)
    p.add_argument("--scene-cap", type=int, default=1024)
    p.add_argument("--device", default="cuda",
                   help="torch device of the pipelines (default cuda)")


def _cascade_from_args(a):
    from .models.cascade import CascadeParams

    acc = a.accuracy
    return CascadeParams(
        clustering_step=a.clustering_step, cluster_filter_thresh=a.cluster_filter_thresh,
        orientation_clustering_th=a.orientation_clustering_th, icp_max_iter=a.icp_max_iter,
        icp_max_corr_dist=a.icp_max_corr_dist, icp_tr_epsilon=a.icp_tr_epsilon,
        icp_ransac_thresh=a.icp_ransac_thresh, bias_x=a.bias_x, canonicalize=a.canonicalize,
        icp_variant="point_to_plane" if acc else a.icp_variant,
        orientation_hypotheses=2 if acc else 1, nms_after_pose=acc,
        max_clusters=a.max_clusters, model_cap=a.model_cap, scene_cap=a.scene_cap,
    )


def cmd_train(a) -> int:
    from .models.templates import DetectorParams
    from .models.trainer import TrainerConfig, train_from_stl
    from .utils.viewsphere import ViewSphereParams

    cfg = TrainerConfig(
        view_sphere=ViewSphereParams(n_points=a.n_points, angle_step=a.angle_step,
                                     radius_min=a.radius_min, radius_max=a.radius_max,
                                     radius_step=a.radius_step),
        width=a.width, height=a.height, focal_length_x=a.fx, focal_length_y=a.fy,
        near=a.near, far=a.far, detector=DetectorParams(use_depth_normal=a.rgb_depth),
        class_id=a.class_id,
    )
    _, bank = train_from_stl(a.stl, cfg, max_views=a.max_views, progress=True,
                             device=a.device)
    bank.write_templates_yaml(a.templates_out)
    bank.write_params_yaml(a.params_out)
    print(json.dumps({"templates": bank.num_templates, "templates_yml": a.templates_out,
                      "params_yml": a.params_out}), flush=True)
    return 0


def _pipeline_from_args(a, templates_yml, params_yml, stl):
    from .models.pipeline import DetectionPipeline
    from .utils import native

    if not native.available():
        raise RuntimeError("the native bank loader did not build (g++ and "
                           "native/bank_loader.cpp are needed to read the banks)")
    return DetectionPipeline.from_files(templates_yml, params_yml, stl,
                                        _cascade_from_args(a), device=a.device)


def cmd_detect(a) -> int:
    from .api.nodes import ReplayFrameSource

    pipe = _pipeline_from_args(a, a.templates, a.params, a.stl)
    src = ReplayFrameSource(a.frames)
    for i in range(a.count if a.count > 0 else len(src.frames)):
        f = src()
        dets = pipe.detect(f.rgb, f.cloud, a.threshold)
        print(json.dumps({
            "frame": i,
            "detections": [
                {"pose": np.asarray(d.pose).tolist(), "rect": list(d.rect),
                 "score": d.score, "icp_fitness": d.icp_fitness, "hv_rate": d.hv_rate}
                for d in dets
            ],
        }), flush=True)
    return 0


def cmd_serve(a) -> int:
    from .api.nodes import ReplayFrameSource
    from .api.service import ObjectConfig, PoseService

    src = ReplayFrameSource(a.frames)
    svc = PoseService(src, bias_x=a.bias_x)
    # --object id:templates.yml:params.yml:mesh.stl[:threshold], repeatable:
    # the reference service's registry (0 = memory chip, 1 = CPU).
    for spec in a.object:
        parts = spec.split(":")
        if len(parts) not in (4, 5):
            print(f"bad --object spec: {spec}", file=sys.stderr)
            return 2
        thr = float(parts[4]) if len(parts) == 5 else a.threshold
        pipe = _pipeline_from_args(a, parts[1], parts[2], parts[3])
        svc.register_object(int(parts[0]), ObjectConfig(pipeline=pipe, threshold=thr))
    print(json.dumps({"serving": sorted(svc.objects)}), flush=True)
    # One object_id per line (a bare int or {"object_id": N}), one
    # base-frame Transform JSON line back; identity on a miss.
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        if line in ("q", "quit", "exit"):
            break
        try:
            req = json.loads(line)
            object_id = int(req["object_id"]) if isinstance(req, dict) else int(req)
        except (ValueError, TypeError, KeyError):
            print(json.dumps({"error": f"bad request {line!r}"}), flush=True)
            continue
        t = svc.linemod_object_pose(object_id)
        print(json.dumps({
            "object_id": object_id,
            "translation": [float(v) for v in t.translation],
            "rotation_xyzw": [float(v) for v in t.rotation],
        }), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="linemod_pose_estimation_tpu_torch",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    pt = sub.add_parser("train", help="render view sphere -> template bank")
    _add_trainer_args(pt)
    pt.set_defaults(fn=cmd_train)

    pd = sub.add_parser("detect", help="detect objects in replay frames")
    pd.add_argument("templates", help="templates.yml")
    pd.add_argument("params", help="renderer_params.yml")
    pd.add_argument("stl", help="CAD mesh")
    pd.add_argument("frames", help="replay .npz file or directory")
    pd.add_argument("--count", type=int, default=0, help="frames to process (0 = all)")
    _cascade_args(pd)
    pd.set_defaults(fn=cmd_detect)

    ps = sub.add_parser("serve", help="pose service over stdin/stdout")
    ps.add_argument("frames", help="replay .npz file or directory (camera seam)")
    ps.add_argument("--object", action="append", default=[],
                    metavar="ID:TEMPLATES:PARAMS:STL[:THRESHOLD]",
                    help="register an object (repeatable)")
    _cascade_args(ps)
    ps.set_defaults(fn=cmd_serve)

    a = ap.parse_args(argv)
    return a.fn(a)


if __name__ == "__main__":
    sys.exit(main())
