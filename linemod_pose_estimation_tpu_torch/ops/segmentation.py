"""Cloud segmentation ops — the port of
``linemod_pose_estimation_tpu/ops/segmentation.py``: the neighbour graph
and k-NN PCA normals (the local-descriptor pose and the grasp planner),
moving-least-squares smoothing, region growing and euclidean clustering
(the grasp planner, ``models/grasp.py``).

Clouds are ``(points (..., N, 3), valid (..., N))`` with any leading lane
dimensions for ``knn_indices``, ``gather_points``, ``estimate_normals`` and
``mls_smooth``; the connectivity ops take one cloud (N, 3).

Region growing and clustering are min-label propagation over the k-NN
graph, as in the reference: each step every point takes the least label
among itself and the neighbours its edges admit.  The reference loops to a
fixed point, capped at `max_iters` steps; a fixed point is stable, so the
port runs all `max_iters` steps on the device with no host check between
them, and ends with the same labels.
"""

from __future__ import annotations

import math

import torch

from ..utils.pointcloud import pad_cloud, pairwise_sq_dists
from .match import _topk_first_index

_NO_LABEL = 2**30  # the label of invalid points and of a masked edge


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


def _neighbourhood_cov(nb: torch.Tensor, w: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean (..., N, 3) and covariance (..., N, 3, 3) of each point's
    neighbours nb (..., N, k, 3) where the mask w (..., N, k) holds."""
    w = w.to(nb.dtype)[..., None]
    cnt = w.sum(dim=-2).clamp(min=1.0)
    mean = (nb * w).sum(dim=-2) / cnt
    d = (nb - mean[..., None, :]) * w
    return mean, d.transpose(-1, -2) @ d / cnt[..., None]


def estimate_normals(points: torch.Tensor, valid: torch.Tensor, k: int = 50,
                     viewpoint=(0.0, 0.0, 0.0)) -> tuple[torch.Tensor, torch.Tensor]:
    """k-NN PCA normals + curvature: the eigenvector of the smallest
    eigenvalue of each point's neighbourhood covariance, oriented towards
    `viewpoint`; curvature = smallest eigenvalue / trace.  Returns
    (normals (..., N, 3), curvature (..., N))."""
    idx, ok = knn_indices(points, valid, k)
    _, cov = _neighbourhood_cov(gather_points(points, idx), ok)
    evals, evecs = torch.linalg.eigh(cov)  # ascending
    normal = evecs[..., 0]
    vp = torch.tensor(viewpoint, dtype=points.dtype, device=points.device)
    flip = (normal * (points - vp)).sum(dim=-1) > 0
    normal = torch.where(flip[..., None], -normal, normal)
    tr = evals.sum(dim=-1).clamp(min=1e-12)
    return normal, evals[..., 0] / tr


def mls_smooth(points: torch.Tensor, valid: torch.Tensor, radius: float = 0.04,
               k: int = 32) -> torch.Tensor:
    """First-order moving least squares (PCL MovingLeastSquares without
    the polynomial refit): each valid point projected onto the PCA plane
    of its k nearest neighbours within `radius`; invalid points unchanged.

    The reference compares with ``radius * radius``, a Python double
    rounded once to f32.  A point with fewer than three neighbours within
    `radius` has a rank-deficient covariance whose smallest eigenvalue
    repeats, and the plane is whichever eigenvector the solver returns:
    with none (a zero covariance and mean) LAPACK's identity puts the point
    on the plane x = 0 through the origin.  That is the reference's
    behaviour, kept as it is."""
    idx, ok = knn_indices(points, valid, k)
    nb = gather_points(points, idx)
    r2 = torch.tensor(radius * radius, dtype=points.dtype, device=points.device)
    within = ok & (((nb - points[..., None, :]) ** 2).sum(dim=-1) < r2)
    mean, cov = _neighbourhood_cov(nb, within)
    normal = torch.linalg.eigh(cov)[1][..., 0]
    off = ((points - mean) * normal).sum(dim=-1, keepdim=True)
    return torch.where(valid[..., None], points - off * normal, points)


def _propagate_min_labels(labels0: torch.Tensor, nbr_idx: torch.Tensor,
                          edge_ok: torch.Tensor, max_iters: int = 64) -> torch.Tensor:
    """Min-label propagation over a directed k-NN graph: `max_iters` steps
    of labels = min(labels, min over admitted edges of the neighbour's
    label).  The reference stops early at a fixed point, which further
    steps keep."""
    labels = labels0
    for _ in range(max_iters):
        nl = torch.where(edge_ok, labels[nbr_idx], _NO_LABEL)
        labels = torch.minimum(labels, nl.amin(dim=1))
    return labels


def _largest_component(valid: torch.Tensor, nbr_idx: torch.Tensor,
                       edge_ok: torch.Tensor, min_cluster: int,
                       max_iters: int) -> torch.Tensor:
    """Mask of the component with the most valid points (the lowest label
    on ties), empty when it has fewer than `min_cluster`."""
    n = valid.shape[0]
    ar = torch.arange(n, dtype=torch.int32, device=valid.device)
    labels = _propagate_min_labels(torch.where(valid, ar, _NO_LABEL), nbr_idx, edge_ok,
                                   max_iters)
    counts = torch.zeros(n, dtype=torch.int32, device=valid.device).scatter_add_(
        0, labels.clamp(0, n - 1).long(), valid.to(torch.int32))
    big = counts.argmax()
    return valid & (labels == big) & (counts[big] >= min_cluster)


def region_growing_largest(points: torch.Tensor, valid: torch.Tensor,
                           normals: torch.Tensor, curvature: torch.Tensor,
                           smoothness_deg: float, curvature_thresh: float,
                           k: int = 30, min_cluster: int = 50,
                           max_iters: int = 64) -> torch.Tensor:
    """The largest smooth region's mask (pcl::RegionGrowing with its
    smoothness and curvature thresholds, then the largest region).  An
    edge to a neighbour is admitted when the normals' angle is within
    `smoothness_deg` and the neighbour's curvature is below
    `curvature_thresh` (propagation passes through low-curvature points
    only, the reference's documented deviation from PCL's seed gate).

    The thresholds are f32 values in the reference (traced under jit), so
    cos(radians(deg)) is taken in f32 here too."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=points.device)
    nbr_idx, ok = knn_indices(points, valid, k)
    cos_th = torch.cos(f32(smoothness_deg) * f32(math.pi / 180))
    ndot = (normals[:, None, :] * normals[nbr_idx]).sum(dim=-1).abs()
    src_seed = curvature < f32(curvature_thresh)
    edge_ok = ok & (ndot > cos_th) & src_seed[nbr_idx]
    return _largest_component(valid, nbr_idx, edge_ok, min_cluster, max_iters)


def euclidean_cluster_largest(points: torch.Tensor, valid: torch.Tensor,
                              tolerance: float, k: int = 16, min_cluster: int = 50,
                              max_iters: int = 64) -> torch.Tensor:
    """The largest euclidean cluster's mask (EuclideanClusterExtraction
    with setClusterTolerance, keeping the largest): edges to the k nearest
    neighbours closer than `tolerance`.  The reference squares the
    tolerance as an f32 product of an f32 value."""
    nbr_idx, ok = knn_indices(points, valid, k)
    nb = points[nbr_idx]
    tol = torch.tensor(tolerance, dtype=torch.float32, device=points.device)
    close = ((nb - points[:, None, :]) ** 2).sum(dim=-1) < tol * tol
    return _largest_component(valid, nbr_idx, ok & close, min_cluster, max_iters)
