"""Neighbour graph and k-NN PCA normals of a point cloud — the part of
``linemod_pose_estimation_tpu/ops/segmentation.py`` that the local
descriptor pose needs (``knn_indices``, ``estimate_normals``).  The rest
of that module (smoothing, region growing, clustering) is not ported yet.

Clouds are ``(points (..., N, 3), valid (..., N))`` with any leading lane
dimensions.
"""

from __future__ import annotations

import torch

from ..utils.pointcloud import pad_cloud, pairwise_sq_dists
from .match import _topk_first_index


def knn_indices(points: torch.Tensor, valid: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., N, k) neighbour indices, nearest first, and their validity
    (self excluded, invalid points infinitely far).  Equal distances,
    also among the infinite ones, take the lower index first."""
    pts = pad_cloud(points, valid)
    d2 = pairwise_sq_dists(pts, pts)
    n = points.shape[-2]
    eye = torch.eye(n, dtype=torch.bool, device=points.device)
    d2 = torch.where(eye, torch.inf, d2)
    d2 = torch.where(valid[..., None, :], d2, torch.inf)
    neg, idx = _topk_first_index(-d2, k)
    return idx, torch.isfinite(neg) & valid[..., None]


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (..., N, 3) at idx (..., *S) -> (..., *S, 3)."""
    lead = points.shape[:-2]
    flat = idx.reshape(*lead, -1)
    out = torch.gather(points, -2, flat[..., None].expand(*flat.shape, 3))
    return out.reshape(*idx.shape, 3)


def estimate_normals(points: torch.Tensor, valid: torch.Tensor, k: int = 50,
                     viewpoint=(0.0, 0.0, 0.0)) -> tuple[torch.Tensor, torch.Tensor]:
    """k-NN PCA normals + curvature: the eigenvector of the smallest
    eigenvalue of each point's neighbourhood covariance, oriented towards
    `viewpoint`; curvature = smallest eigenvalue / trace.  Returns
    (normals (..., N, 3), curvature (..., N))."""
    idx, ok = knn_indices(points, valid, k)
    nb = gather_points(points, idx)  # (..., N, k, 3)
    w = ok.to(points.dtype)[..., None]
    cnt = w.sum(dim=-2).clamp(min=1.0)
    mean = (nb * w).sum(dim=-2) / cnt
    d = (nb - mean[..., None, :]) * w
    cov = d.transpose(-1, -2) @ d / cnt[..., None]
    evals, evecs = torch.linalg.eigh(cov)  # ascending
    normal = evecs[..., 0]
    vp = torch.tensor(viewpoint, dtype=points.dtype, device=points.device)
    flip = (normal * (points - vp)).sum(dim=-1) > 0
    normal = torch.where(flip[..., None], -normal, normal)
    tr = evals.sum(dim=-1).clamp(min=1e-12)
    return normal, evals[..., 0] / tr
