"""The plain reference of one detect: the reference matcher's single-frame
matches, then the frozen copy of the pose stage (clustering, IoU NMS,
rough pose with a re-render in the plain z-buffer scan, ICP, verification,
canonicalization) at the default cascade parameters.

The stage order and the operands follow the program's
``models/pipeline.py::DetectionPipeline`` (copied, not imported).
"""

from __future__ import annotations

import numpy as np
import torch

from .bank import Bank, Params
from .matcher import Matches, ReferenceMatcher
from .pose import cascade as CC
from .pose import geometry as geo
from .pose.renderer import _pad_triangles


class ReferenceDetect:
    """`detect(rgb, depth_mm, cloud)` -> (the frame's Matches, its
    detections), each detection a dict of pose (4, 4), rect (x, y, w, h)
    and score, sorted by score as the program sorts them.  `threshold` is
    the reported similarity threshold."""

    def __init__(self, bank: Bank, params: Params, triangles: np.ndarray,
                 threshold: float, device="cuda", dtype=torch.float32):
        self.p = CC.CascadeParams()
        self.device = dev = torch.device(device)
        self.threshold = threshold
        self.matcher = ReferenceMatcher(bank, threshold, self.p.max_matches,
                                        order="template", device=dev, dtype=dtype)
        g = params.globals
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        self.triangles = f32(_pad_triangles(np.asarray(triangles, np.float32), 64))
        W, H = int(g["width"]), int(g["height"])
        self.render_wh = (W, H)
        self.K_render = f32([[g["focal_length_x"] * W / W, 0, W / 2.0],
                             [0, g["focal_length_y"] * H / H, H / 2.0], [0, 0, 1.0]])
        self.radius_min, self.radius_step = g["radius_min"], g["radius_step"]
        self.q_bank = geo.quat_from_matrix(f32(params.R))
        self.T_bank = f32(params.T)
        self.D_bank = f32(params.D)
        self.Od_bank = f32(params.Ori_dist)
        self.Rect_bank = torch.as_tensor(np.asarray(params.Rect, np.int32), device=dev)

    def matches(self, rgb: np.ndarray, depth_mm: np.ndarray) -> Matches:
        """The frame's matches padded to max_matches slots, in slot order."""
        m = self.matcher.match(rgb[None], depth_mm[None])[0]
        k, n = self.p.max_matches, len(m["valid"])
        pad = lambda a, dt: torch.from_numpy(
            np.concatenate([np.asarray(a, dt), np.zeros(k - n, dt)])).to(self.device)
        return Matches(pad(m["template_id"], np.int32), pad(m["x"], np.int32),
                       pad(m["y"], np.int32), pad(m["similarity"], np.float32),
                       pad(m["valid"], bool))

    def detect(self, rgb: np.ndarray, depth_mm: np.ndarray,
               cloud: np.ndarray) -> tuple[Matches, list[dict]]:
        p = self.p
        matches = self.matches(rgb, depth_mm)
        cloud = torch.as_tensor(np.asarray(cloud, np.float32), device=self.device)
        clusters = CC.cluster_matches(
            matches, self.Od_bank, self.Rect_bank, self.radius_min, self.radius_step,
            p.clustering_step, p.cluster_filter_thresh, p.max_cells, p.members_cap)
        keep = CC.nms_iou(clusters, p.iou_threshold)
        alive = clusters.valid & keep
        order = torch.argsort(-torch.where(alive, clusters.score, -torch.inf),
                              stable=True)[:p.max_clusters]
        midx = clusters.member_idx[order].long()
        tids = matches.template_id[midx].long()
        poses = CC.rough_pose_and_refine(
            self.q_bank[tids], self.T_bank[tids], self.D_bank[tids], self.Od_bank[tids],
            matches.x[midx].to(torch.float32), matches.y[midx].to(torch.float32),
            matches.similarity[midx], clusters.member_valid[order], alive[order],
            clusters.score[order], cloud=cloud, triangles=self.triangles,
            K_render=self.K_render, params=p, render_wh=self.render_wh,
            scene_normals=None)
        host = CC.ClusterPose(*(a.cpu() for a in poses))
        out = [dict(pose=host.pose[i].numpy().astype(np.float64),
                    rect=tuple(int(v) for v in host.rect[i]), score=float(host.score[i]))
               for i in np.nonzero(host.valid.numpy())[0]]
        out.sort(key=lambda d: -d["score"])
        return matches, out
