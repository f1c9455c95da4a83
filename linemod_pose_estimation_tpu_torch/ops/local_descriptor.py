"""SHOT-style descriptors + Hough-3D voting: a rigid pose between a model
cloud and a scene cloud without ICP — the port of
``linemod_pose_estimation_tpu/ops/local_descriptor.py`` (the reference's
analog of getPoseByLocalDescriptor):

    k-NN PCA normals            ops.segmentation.estimate_normals
    uniform-sampling keypoints  select_keypoints: first point of each voxel
    local reference frames      eigenvectors of the radius-weighted support
                                covariance, signs towards the weighted
                                majority of the support
    descriptors                 352 slots: 8 azimuth x 2 elevation x 2 radial
                                sectors x 11 bins of |cos| between a support
                                normal and the frame's z; L2-normalized; the
                                histogram is a scatter-add of 0/1 (exact in
                                any order)
    matching                    nearest model descriptor per scene keypoint
    Hough voting                each correspondence votes for the model
                                reference point through its frame pair; the
                                fullest voxel's correspondences give the
                                pose by weighted Kabsch

Every function takes leading lane dimensions: clouds are ``(points
(..., N, 3), valid (..., N))``, keypoint sets ``(..., K)``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..utils import pointcloud as pcu
from .icp import _kabsch
from .segmentation import estimate_normals, gather_points

N_AZIMUTH = 8
N_ELEVATION = 2
N_RADIAL = 2
N_COS = 11
SHOT_DIM = N_AZIMUTH * N_ELEVATION * N_RADIAL * N_COS  # 352
_INT32_MAX = 2**31 - 1


def select_keypoints(points: torch.Tensor, valid: torch.Tensor, leaf: float,
                     k_cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """At most one point per `leaf`-sized voxel, the first in the voxel
    (lowest index) wins; voxels in ascending hash order.  Returns
    (indices (..., k_cap) int32, valid (..., k_cap))."""
    h = torch.where(valid, pcu._voxel_hash(points, leaf), _INT32_MAX)
    hs, order = torch.sort(h, dim=-1, stable=True)
    first = torch.ones_like(valid)
    first[..., 1:] = hs[..., 1:] != hs[..., :-1]
    first = first & torch.gather(valid, -1, order)
    f = first.to(torch.int64)
    pos = torch.where(first, torch.cumsum(f, dim=-1) - 1, k_cap)
    out = torch.zeros(valid.shape[:-1] + (k_cap + 1,), dtype=torch.int32,
                      device=points.device)
    out.scatter_(-1, pos.clamp(max=k_cap), order.to(torch.int32))
    ok = torch.arange(k_cap, device=points.device) < f.sum(dim=-1, keepdim=True)
    return out[..., :k_cap].contiguous(), ok


def _support(points: torch.Tensor, kp_idx: torch.Tensor) -> torch.Tensor:
    """points - keypoint, (..., K, N, 3)."""
    kp = gather_points(points, kp_idx.long())
    return points[..., None, :, :] - kp[..., :, None, :]


def local_reference_frames(points: torch.Tensor, valid: torch.Tensor,
                           kp_idx: torch.Tensor, radius: float) -> torch.Tensor:
    """(..., K, 3, 3) local reference frames (rows = x, y, z axes): the
    eigenvectors of the support covariance weighted by (radius - d); x
    (largest eigenvalue) and z (smallest) signed towards the weighted
    majority of the support; y = z x x."""
    diff = _support(points, kp_idx)
    d = torch.sqrt((diff * diff).sum(dim=-1))
    w = (radius - d).clamp(min=0.0) * valid[..., None, :]
    wsum = w.sum(dim=-1).clamp(min=1e-9)
    cov = (diff * w[..., None]).transpose(-1, -2) @ diff / wsum[..., None, None]
    _, evecs = torch.linalg.eigh(cov)  # ascending eigenvalues
    z, x = evecs[..., 0], evecs[..., 2]

    def towards_majority(axis):
        s = (w * (diff @ axis[..., None])[..., 0]).sum(dim=-1)
        return torch.where((s < 0)[..., None], -axis, axis)

    x, z = towards_majority(x), towards_majority(z)
    return torch.stack([x, torch.linalg.cross(z, x, dim=-1), z], dim=-2)


def shot_descriptors(points: torch.Tensor, valid: torch.Tensor, normals: torch.Tensor,
                     kp_idx: torch.Tensor, kp_valid: torch.Tensor, lrf: torch.Tensor,
                     radius: float) -> torch.Tensor:
    """(..., K, 352) descriptors, L2-normalized: each support point within
    `radius` counts once, in the slot of its spatial sector in the
    keypoint's frame and of |cos| between its normal and the frame's z."""
    diff = _support(points, kp_idx)
    local = diff @ lrf.transpose(-1, -2)  # (..., K, N, 3): components along x, y, z
    d = torch.sqrt((local * local).sum(dim=-1))
    inside = (d < radius) & (d > 1e-9) & valid[..., None, :] & kp_valid[..., :, None]

    az = torch.atan2(local[..., 1], local[..., 0])  # (-pi, pi]
    az_bin = torch.floor((az + math.pi) * (N_AZIMUTH / (2 * math.pi))
                         ).to(torch.int64).clamp(0, N_AZIMUTH - 1)
    el_bin = (local[..., 2] > 0).to(torch.int64)
    rad_bin = (d > radius * 0.5).to(torch.int64)
    z_axis = lrf[..., 2, :]  # (..., K, 3)
    cosang = (z_axis @ normals.transpose(-1, -2)).clamp(-1.0, 1.0).abs()
    cos_bin = torch.floor(cosang * N_COS).to(torch.int64).clamp(0, N_COS - 1)
    didx = ((az_bin * N_ELEVATION + el_bin) * N_RADIAL + rad_bin) * N_COS + cos_bin

    desc = torch.zeros(didx.shape[:-1] + (SHOT_DIM,), device=points.device)
    desc.scatter_add_(-1, didx, inside.to(torch.float32))
    norm = torch.sqrt((desc * desc).sum(dim=-1, keepdim=True)).clamp(min=1e-9)
    return desc / norm


def match_descriptors(desc_scene: torch.Tensor, scene_valid: torch.Tensor,
                      desc_model: torch.Tensor, model_valid: torch.Tensor,
                      max_sq_dist: float = 0.25) -> tuple[torch.Tensor, torch.Tensor]:
    """The nearest model descriptor of each scene keypoint (the first on
    ties), accepted below `max_sq_dist`.  Returns (model index (..., Ks)
    int32, valid)."""
    d2 = ((desc_scene ** 2).sum(dim=-1)[..., :, None]
          - 2.0 * (desc_scene @ desc_model.transpose(-1, -2))
          + (desc_model ** 2).sum(dim=-1)[..., None, :])
    d2 = torch.where(model_valid[..., None, :], d2, torch.inf)
    j = d2.argmin(dim=-1)
    best = torch.gather(d2, -1, j[..., None])[..., 0]
    return j.to(torch.int32), scene_valid & (best < max_sq_dist) & torch.isfinite(best)


class LocalDescriptorPose(NamedTuple):
    pose: torch.Tensor  # (..., 4, 4) model -> scene rigid transform
    votes: torch.Tensor  # (...,) int32: the winning Hough cell's population
    n_correspondences: torch.Tensor  # (...,) int32
    valid: torch.Tensor  # (...,) bool


def hough_pose(scene_kp: torch.Tensor, model_kp: torch.Tensor, scene_lrf: torch.Tensor,
               model_lrf: torch.Tensor, model_ref: torch.Tensor, corr_model: torch.Tensor,
               corr_valid: torch.Tensor, bin_size: float, min_votes: int
               ) -> LocalDescriptorPose:
    """Every correspondence votes for the model reference point's place in
    the scene through its frame pair; votes fall into `bin_size` voxels;
    the fullest voxel (the first on ties) gives the pose by Kabsch over
    its correspondences."""
    m = corr_model.long()
    mk = gather_points(model_kp, m)
    mlrf = torch.gather(model_lrf, -3, m[..., None, None].expand(*m.shape, 3, 3))
    off_local = (mlrf @ (model_ref[..., None, :] - mk)[..., None])[..., 0]
    votes = scene_kp + (scene_lrf.transpose(-1, -2) @ off_local[..., None])[..., 0]

    h = torch.where(corr_valid, pcu._voxel_hash(votes, bin_size), _INT32_MAX)
    same = ((h[..., :, None] == h[..., None, :])
            & corr_valid[..., None, :] & corr_valid[..., :, None])
    pop = same.sum(dim=-1)
    winner = pop.argmax(dim=-1)
    in_cell = torch.gather(same, -2, winner[..., None, None].expand(
        *winner.shape, 1, same.shape[-1]))[..., 0, :]
    n_votes = torch.gather(pop, -1, winner[..., None])[..., 0]
    T = _kabsch(mk, scene_kp, in_cell.to(torch.float32))
    return LocalDescriptorPose(pose=T, votes=n_votes.to(torch.int32),
                               n_correspondences=corr_valid.sum(dim=-1).to(torch.int32),
                               valid=n_votes >= min_votes)


def get_pose_by_local_descriptor(model_pts: torch.Tensor, model_valid: torch.Tensor,
                                 scene_pts: torch.Tensor, scene_valid: torch.Tensor,
                                 keypoint_leaf: float = 0.01, descr_radius: float = 0.02,
                                 lrf_radius: float = 0.015, bin_size: float = 0.01,
                                 max_sq_dist: float = 0.25, k_cap: int = 128,
                                 normal_k: int = 10, min_votes: int = 5
                                 ) -> LocalDescriptorPose:
    """The whole chain: normals -> keypoints -> frames -> descriptors ->
    matching -> Hough voting -> pose."""
    sides = []
    for pts, valid in ((model_pts, model_valid), (scene_pts, scene_valid)):
        normals, _ = estimate_normals(pts, valid, k=normal_k)
        ki, kv = select_keypoints(pts, valid, keypoint_leaf, k_cap)
        lrf = local_reference_frames(pts, valid, ki, lrf_radius)
        desc = shot_descriptors(pts, valid, normals, ki, kv, lrf, descr_radius)
        sides.append((gather_points(pts, ki.long()), kv, lrf, desc))
    (m_kp, mkv, mlrf, mdesc), (s_kp, skv, slrf, sdesc) = sides
    corr, cok = match_descriptors(sdesc, skv, mdesc, mkv, max_sq_dist)
    model_ref = pcu.masked_centroid(model_pts, model_valid)
    return hough_pose(s_kp, m_kp, slrf, mlrf, model_ref, corr, cok, bin_size, min_votes)
