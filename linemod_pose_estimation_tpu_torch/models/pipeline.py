"""DetectionPipeline: the full per-frame flow of the reference's
detect_cb behind one object — the port of
``linemod_pose_estimation_tpu/models/pipeline.py``.

    pipeline = DetectionPipeline(detector, metadata, globals_, mesh, params)
    detections = pipeline.detect(rgb, cloud, depth_mm=depth)

Stage order: LINEMOD match (Detector.match_raw: K1, K2, K3) -> vote
clustering -> IoU NMS -> per-cluster rough pose with a re-render (K4)
-> ICP -> verification -> canonicalization; with
``CascadeParams.nms_after_pose`` the NMS comes after the pose, over twice
the pose slots, ranked by verification.  Everything runs on the
detector's device; the cluster lanes run as one batch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import match as M
from ..utils import geometry as geo
from ..utils.device import DEFAULT_DEVICE
from . import cascade as CC
from .detector import Detector, to_device
from .renderer import _pad_triangles
from .templates import RendererGlobals, TemplateBank, TemplateMetadata


@dataclass
class Detection:
    """One verified object hypothesis."""

    pose: np.ndarray  # (4, 4) object -> camera
    rect: tuple[int, int, int, int]
    score: float
    icp_fitness: float
    hv_rate: float
    rough_pose: np.ndarray | None = None  # pre-ICP pose


@dataclass
class StageOutputs:
    """Per-stage intermediates of one detect() call (tensors on the
    pipeline's device; mask by the valid fields)."""

    matches: M.Matches  # raw LINEMOD matches (after the walk)
    clusters: "CC.ClusterSet"  # vote cells after grouping + filtering
    nms_keep: np.ndarray  # (C,) bool — IoU-NMS survivors among clusters
    cluster_order: np.ndarray  # (max_clusters,) cluster indices by score
    poses: "CC.ClusterPose"  # per-lane rough + refined poses, HV rates


class DetectionPipeline:
    def __init__(self, detector: Detector, metadata: TemplateMetadata,
                 globals_: RendererGlobals, mesh_or_path,
                 params: CC.CascadeParams | None = None, class_id: str | None = None,
                 render_size: tuple[int, int] | None = None):
        from ..utils.stl import load_stl

        self.detector = detector
        self.device = detector.device
        self.class_id = class_id or detector.class_ids[0]
        self.params = params or CC.CascadeParams()
        self.metadata = metadata
        self.globals = globals_
        dev = self.device
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)

        mesh = load_stl(mesh_or_path) if isinstance(mesh_or_path, str) else mesh_or_path
        self.triangles = f32(_pad_triangles(mesh.triangles.astype(np.float32), 64))
        rw, rh = render_size or (globals_.width, globals_.height)
        self.render_wh = (rw, rh)
        self.K_render = f32([
            [globals_.focal_length_x * rw / globals_.width, 0, rw / 2.0],
            [0, globals_.focal_length_y * rh / globals_.height, rh / 2.0],
            [0, 0, 1.0],
        ])
        # The sensor frame's own intrinsics: the organized scene cloud is
        # frame-sized, so its normals must not take K_render's scaled focals.
        self.K_frame = f32([
            [globals_.focal_length_x, 0, globals_.width / 2.0],
            [0, globals_.focal_length_y, globals_.height / 2.0],
            [0, 0, 1.0],
        ])
        self.q_bank = geo.quat_from_matrix(f32(metadata.R))
        self.T_bank = f32(metadata.T)
        self.D_bank = f32(metadata.D)
        self.Od_bank = f32(metadata.Ori_dist)
        self.Rect_bank = torch.as_tensor(np.asarray(metadata.Rect, np.int32), device=dev)

    def scene_normals(self, cloud: torch.Tensor) -> torch.Tensor | None:
        """Per-pixel scene normals for point-to-plane ICP, once per frame,
        from the organized cloud's depth; None for the other variants."""
        if self.params.icp_variant != "point_to_plane":
            return None
        from ..ops.verification import depth_normals

        z = cloud[..., 2]
        return depth_normals(torch.where(torch.isfinite(z), z, 0.0) * 1000.0, self.K_frame)

    def _pose_stage(self, matches: M.Matches, cloud: torch.Tensor):
        p = self.params
        scene_normals = self.scene_normals(cloud)
        clusters = CC.cluster_matches(
            matches, self.Od_bank, self.Rect_bank, self.globals.radius_min,
            self.globals.radius_step, p.clustering_step, p.cluster_filter_thresh,
            p.max_cells, p.members_cap)
        if p.nms_after_pose:
            # Pose and verify every top cluster first, over twice the pose
            # slots (near-duplicate clusters of one strong object must not
            # crowd a weaker second instance out), then suppress by IoU
            # ranked by verification: a symmetric flip can out-score the
            # true orientation but not out-verify it.
            keep, n_slots = clusters.valid, 2 * p.max_clusters
        else:
            keep, n_slots = CC.nms_iou(clusters, p.iou_threshold), p.max_clusters
        alive = clusters.valid & keep
        order = torch.argsort(-torch.where(alive, clusters.score, -torch.inf),
                              stable=True)[:n_slots]
        midx = clusters.member_idx[order].long()  # (C, M)
        tids = matches.template_id[midx].long()
        poses = CC.rough_pose_and_refine(
            self.q_bank[tids], self.T_bank[tids], self.D_bank[tids], self.Od_bank[tids],
            matches.x[midx].to(torch.float32), matches.y[midx].to(torch.float32),
            matches.similarity[midx], clusters.member_valid[order], alive[order],
            clusters.score[order], cloud=cloud, triangles=self.triangles,
            K_render=self.K_render, params=p, render_wh=self.render_wh,
            scene_normals=scene_normals)
        if p.nms_after_pose:
            keep2 = CC.nms_rects(
                poses.rect, poses.hyp_sim + poses.hv_rate - 1e4 * poses.icp_fitness,
                poses.valid, p.iou_threshold)
            poses = poses._replace(valid=poses.valid & keep2)
        return poses, clusters, keep, order

    def detect(self, rgb, cloud, threshold: float = 91.0, depth_mm=None,
               return_stages: bool = False):
        """Run the full cascade on one frame; returns verified detections
        sorted by score (an empty list = no object).  With
        return_stages=True, returns (detections, StageOutputs)."""
        matches = self.detector.match_raw(
            rgb, threshold, depth_mm=depth_mm, class_ids=[self.class_id],
            top_k=self.params.max_matches)[self.class_id]
        cloud = to_device(cloud, torch.float32, self.device)
        poses, clusters, keep, order = self._pose_stage(matches, cloud)

        host = CC.ClusterPose(*(a.cpu() for a in poses))
        out = [
            Detection(
                pose=host.pose[i].numpy(),
                rect=tuple(int(v) for v in host.rect[i]),
                score=float(host.score[i]),
                icp_fitness=float(host.icp_fitness[i]),
                hv_rate=float(host.hv_rate[i]),
                rough_pose=host.rough_pose[i].numpy(),
            )
            for i in np.nonzero(host.valid.numpy())[0]
        ]
        out.sort(key=lambda d: -d.score)
        if return_stages:
            return out, StageOutputs(matches=matches, clusters=clusters,
                                     nms_keep=keep.cpu().numpy(),
                                     cluster_order=order.cpu().numpy(), poses=poses)
        return out

    def draw_response(self, rgb, matches: M.Matches, max_draw: int = 8) -> np.ndarray:
        """Feature-dot overlay of the first `max_draw` valid matches
        (drawResponse): each match's level-0 features painted at (match.x +
        fx, match.y + fy), coloured by its slot.  The bank's features and
        the matches come to the host once."""
        from ..utils.visualization import draw_features

        palette = [(0, 255, 0), (255, 0, 0), (0, 0, 255), (255, 255, 0),
                   (255, 0, 255), (0, 255, 255), (255, 128, 0), (128, 0, 255)]
        img = np.array(rgb, copy=True)
        feats0 = self.detector.bank(self.class_id).merged_features(0)
        offsets, live = feats0.offsets.cpu().numpy(), feats0.live.cpu().numpy()
        tid, xs, ys = (a.cpu().numpy() for a in (matches.template_id, matches.x, matches.y))
        for slot, i in enumerate(np.nonzero(matches.valid.cpu().numpy())[0][:max_draw]):
            img = draw_features(img, offsets[tid[i]][live[tid[i]]], (int(xs[i]), int(ys[i])),
                                palette[slot % len(palette)])
        return img

    @classmethod
    def from_files(cls, templates_yml: str, params_yml: str, stl_path,
                   cascade_params: CC.CascadeParams | None = None,
                   render_size: tuple[int, int] | None = None,
                   device=DEFAULT_DEVICE) -> "DetectionPipeline":
        """Cold-start from serialized banks and a mesh (an STL path or a
        ``utils.stl.Mesh``)."""
        det = Detector.read(templates_yml, device=device)
        meta, glob = TemplateBank.read_params_yaml(params_yml)
        return cls(det, meta, glob, stl_path, cascade_params, render_size=render_size)
