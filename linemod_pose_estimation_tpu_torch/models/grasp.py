"""Grasp pose by region growing — the port of
``linemod_pose_estimation_tpu/models/grasp.py``
(rgbdDetector::graspingPoseBasedOnRegionGrowing, SURVEY.md C13).

Smooth the scene cloud (MLS), estimate normals, take the largest smooth
region, find its surface point nearest the region's centroid, and build
a pose whose approach axis opposes the surface normal there, backed off
along the normal by `offset`.
"""

from __future__ import annotations

import torch

from ..ops import segmentation as seg
from ..utils import pointcloud as pcu


def grasping_pose_region_growing(
    scene_pts: torch.Tensor,
    scene_valid: torch.Tensor,
    normal_thresh_deg: float = 5.0,
    curvature_thresh: float = 1.0,
    offset: float = 0.05,
    knn_normals: int = 50,
    knn_region: int = 30,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (grasp pose (4, 4) f32, region mask (N,)).

    The rotation is AngleAxis(-(pi - angle(z, n)), z x n / |z x n|): it
    takes the camera z axis onto the anti-normal (the reference normalizes
    the axis, which the original passes unnormalized to Eigen).  An empty
    region takes point 0, as the reference's argmin over all-inf
    distances does.  The thresholds and `offset` are f32 values in the
    reference (traced under jit) and are f32 here."""
    dev = scene_pts.device
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    sm = seg.mls_smooth(scene_pts, scene_valid)
    normals, curvature = seg.estimate_normals(sm, scene_valid, k=knn_normals)
    region = seg.region_growing_largest(sm, scene_valid, normals, curvature,
                                        normal_thresh_deg, curvature_thresh, k=knn_region)

    centroid = pcu.masked_centroid(sm, region)
    d = torch.where(region, ((sm - centroid) ** 2).sum(dim=-1), torch.inf)
    sidx = d.argmin()  # the first minimum
    surf_pt, surf_n = sm[sidx], normals[sidx]

    z = f32([0.0, 0.0, 1.0])
    axis = torch.linalg.cross(z, surf_n)
    axis_n = torch.sqrt((axis * axis).sum())
    axis = torch.where(axis_n > 1e-8, axis / axis_n.clamp(min=1e-8), f32([1.0, 0.0, 0.0]))
    cosang = (z * surf_n).sum().clamp(-1.0, 1.0)
    a = -(f32(torch.pi) - torch.arccos(cosang))

    # Rodrigues for R = AngleAxis(a, axis).
    zero = f32(0.0)
    K = torch.stack([torch.stack([zero, -axis[2], axis[1]]),
                     torch.stack([axis[2], zero, -axis[0]]),
                     torch.stack([-axis[1], axis[0], zero])])
    R = torch.eye(3, device=dev) + torch.sin(a) * K + (1 - torch.cos(a)) * (K @ K)

    pose = torch.eye(4, device=dev)
    pose[:3, :3] = R
    pose[:3, 3] = surf_pt - f32(offset) * surf_n
    return pose, region
