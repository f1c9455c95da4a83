"""DetectionPipeline: the full per-frame flow of the reference's
detect_cb behind one object — the port of
``linemod_pose_estimation_tpu/models/pipeline.py`` (default cascade;
``draw_response`` is not ported yet).

    pipeline = DetectionPipeline(detector, metadata, globals_, mesh, params)
    detections = pipeline.detect(rgb, cloud, depth_mm=depth)

Stage order: LINEMOD match (Detector.match_raw: K1, K2, K3) -> vote
clustering -> IoU NMS -> per-cluster rough pose with a re-render (K4)
-> two-stage ICP -> verification -> canonicalization.  Everything runs on
the detector's device; the cluster lanes run as one batch.
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
        CC.check_ported(self.params)
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
        self.q_bank = geo.quat_from_matrix(f32(metadata.R))
        self.T_bank = f32(metadata.T)
        self.D_bank = f32(metadata.D)
        self.Od_bank = f32(metadata.Ori_dist)
        self.Rect_bank = torch.as_tensor(np.asarray(metadata.Rect, np.int32), device=dev)

    def _pose_stage(self, matches: M.Matches, cloud: torch.Tensor):
        p = self.params
        clusters = CC.cluster_matches(
            matches, self.Od_bank, self.Rect_bank, self.globals.radius_min,
            self.globals.radius_step, p.clustering_step, p.cluster_filter_thresh,
            p.max_cells, p.members_cap)
        keep = CC.nms_iou(clusters, p.iou_threshold)
        alive = clusters.valid & keep
        order = torch.argsort(-torch.where(alive, clusters.score, -torch.inf),
                              stable=True)[:p.max_clusters]
        midx = clusters.member_idx[order].long()  # (C, M)
        tids = matches.template_id[midx].long()
        poses = CC.rough_pose_and_refine(
            self.q_bank[tids], self.T_bank[tids], self.D_bank[tids], self.Od_bank[tids],
            matches.x[midx].to(torch.float32), matches.y[midx].to(torch.float32),
            matches.similarity[midx], clusters.member_valid[order], alive[order],
            clusters.score[order], cloud=cloud, triangles=self.triangles,
            K_render=self.K_render, params=p, render_wh=self.render_wh)
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
