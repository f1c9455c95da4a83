"""Frozen copy of ``linemod_pose_estimation_tpu_torch/utils/pointcloud.py`` for the
benchmark's plain reference: plain PyTorch only, no hand-written kernel,
imported by nothing of the program, and never edited to follow it.

The original's docstring:

Point-cloud primitives with fixed capacity and validity masks — the port
of ``linemod_pose_estimation_tpu/utils/pointcloud.py``.

Convention: a cloud is ``(points (..., N, 3) float32, valid (..., N)
bool)``; invalid slots hold a far sentinel so they never win a
nearest-neighbour query.  Every function takes leading batch dimensions
(the cascade runs its cluster lanes as one batch, where the reference
vmaps).

Division by a Python number goes through a 0-dim tensor on the operand's
device (``true_div``): PyTorch's CUDA kernels multiply by the reciprocal of a
host scalar divisor, which is not one IEEE division.
"""

from __future__ import annotations

import torch

SENTINEL = 1e6  # coordinate for invalid/padded points


def true_div(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s as an IEEE division on every device."""
    return x / torch.tensor(s, dtype=x.dtype, device=x.device)


def pad_cloud(points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Replace invalid points with the far-away sentinel."""
    return torch.where(valid[..., None], points, SENTINEL)


def depth_to_cloud(depth_m: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Depth in metres (..., H, W) -> organized cloud (..., H, W, 3) under
    intrinsics K (..., 3, 3); 0-depth -> NaN."""
    H, W = depth_m.shape[-2:]
    dev = depth_m.device
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    k = lambda i, j: K[..., i, j][..., None, None]
    z = depth_m
    x = (u - k(0, 2)) * z / k(0, 0)
    y = (v - k(1, 2)) * z / k(1, 1)
    cloud = torch.stack([x, y, z], dim=-1)
    return torch.where(depth_m[..., None] > 0, cloud, torch.nan)


def cloud_to_depth_mm(cloud: torch.Tensor) -> torch.Tensor:
    """Organized cloud (..., H, W, 3) in metres -> uint16 depth in
    millimetres: z * 1000 clipped to [0, 65535] and truncated, NaN -> 0
    (the nodes' pc2depth)."""
    z = cloud[..., 2]
    z = torch.where(torch.isnan(z), 0.0, z)
    return (z * 1000.0).clamp(0, 65535).to(torch.int32).to(torch.uint16)


def extract_rect_points(cloud: torch.Tensor, rect_xywh, cap: int,
                        mask: torch.Tensor | None = None, bias_x: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The finite points of an organized cloud (H, W, 3) inside a ROI
    (x, y, w, h) whose columns are shifted by `bias_x` (a 752-wide cloud
    under a 640-wide cropped image); with `mask` (H, W, image coordinates,
    rolled by `bias_x` with wraparound) only its pixels > 0.  Returns
    (points (min(cap, H W), 3) f32, valid): the selected pixels in raster
    order first, then the others with the sentinel, as the reference's
    stable argsort orders them."""
    H, W = cloud.shape[:2]
    dev = cloud.device
    x0, y0, w, h = (int(v) for v in rect_xywh)
    vv = torch.arange(H, device=dev)[:, None]
    uu = torch.arange(W, device=dev)[None, :]
    inside = (uu >= x0 + bias_x) & (uu < x0 + w + bias_x) & (vv >= y0) & (vv < y0 + h)
    if mask is not None:
        shifted = torch.roll(mask > 0, bias_x, dims=1) if bias_x else mask > 0
        inside = inside & shifted
    sel = (inside & torch.isfinite(cloud).all(dim=-1)).reshape(-1)
    order = torch.sort((~sel).to(torch.uint8), stable=True).indices[:cap]
    valid = sel[order]
    pts = torch.where(valid[:, None], cloud.reshape(-1, 3)[order], SENTINEL)
    return pts.to(torch.float32), valid


def masked_centroid(points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    n = valid.sum(dim=-1, keepdim=True).clamp(min=1)
    return torch.where(valid[..., None], points, 0.0).sum(dim=-2) / n


def pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) x (..., M, 3) -> (..., N, M) squared distances.

    The |a|^2 - 2ab + |b|^2 expansion cancels catastrophically for
    mm-scale distances at m-scale coordinates, so both clouds are first
    centred on the mean of b's real (non-sentinel) points, and the cross
    term runs in full f32 (the package pins TF32 off at import)."""
    real = (b.abs() < SENTINEL * 0.5).all(dim=-1, keepdim=True)
    c = torch.where(real, b, 0.0).sum(dim=-2) / real.sum(dim=-2)
    c = torch.where(torch.isfinite(c), c, 0.0)[..., None, :]
    ac, bc = a - c, b - c
    a2 = (ac * ac).sum(dim=-1, keepdim=True)
    b2 = (bc * bc).sum(dim=-1, keepdim=True)
    cross = torch.matmul(ac, bc.transpose(-1, -2))
    return (a2 - 2.0 * cross + b2.transpose(-1, -2)).clamp(min=0.0)


def nearest_point(points: torch.Tensor, valid: torch.Tensor,
                  query: torch.Tensor) -> torch.Tensor:
    """Closest valid point to `query` (..., 3): the first on ties, as
    jnp.argmin."""
    d = ((points - query[..., None, :]) ** 2).sum(dim=-1)
    d = torch.where(valid, d, torch.inf)
    i = d.argmin(dim=-1)
    return torch.gather(points, -2, i[..., None, None].expand(*i.shape, 1, 3))[..., 0, :]


def _voxel_hash(points: torch.Tensor, leaf: float) -> torch.Tensor:
    """(..., N, 3) -> int32 voxel id, 10 bits per axis (coords clipped to
    +-512 voxels around the origin)."""
    ids3 = torch.floor(true_div(points, leaf)).to(torch.int32).clamp(-512, 511) + 512
    return (ids3[..., 0] << 20) | (ids3[..., 1] << 10) | ids3[..., 2]


def statistical_outlier_removal(points: torch.Tensor, valid: torch.Tensor,
                                mean_k: int = 50, std_mul: float = 1.0
                                ) -> torch.Tensor:
    """PCL StatisticalOutlierRemoval: each point's mean distance to its
    `mean_k` nearest neighbours; drop points whose mean exceeds the global
    mean + std_mul * stddev.  Returns the updated validity mask.  The
    k-NN is exact (the reference's approx_max_k is exact off the TPU)."""
    pts = pad_cloud(points, valid)
    d2 = pairwise_sq_dists(pts, pts)
    n = points.shape[-2]
    eye = torch.eye(n, dtype=torch.bool, device=points.device)
    d2 = torch.where(eye, torch.inf, d2)
    d2 = torch.where(valid[..., None, :], d2, torch.inf)
    k = min(mean_k, n - 1)
    near = torch.topk(d2, k, dim=-1, largest=False, sorted=True).values
    dists = torch.sqrt(near.clamp(min=0.0))
    finite = torch.isfinite(dists)
    cnt = finite.sum(dim=-1).clamp(min=1)
    mean_d = torch.where(finite, dists, 0.0).sum(dim=-1) / cnt
    nv = valid.sum(dim=-1, keepdim=True).clamp(min=1)
    mu = torch.where(valid, mean_d, 0.0).sum(dim=-1, keepdim=True) / nv
    var = torch.where(valid, (mean_d - mu) ** 2, 0.0).sum(dim=-1, keepdim=True) / nv
    thresh = mu + std_mul * torch.sqrt(var)
    return valid & (mean_d <= thresh)


def scatter_rows(src: torch.Tensor, pos: torch.Tensor, cap: int,
                 fill: float) -> torch.Tensor:
    """out[..., pos[i], :] = src[..., i, :] into `cap` rows of `fill`;
    positions >= cap are dropped (the reference's mode="drop")."""
    out = torch.full(src.shape[:-2] + (cap + 1, src.shape[-1]), fill,
                     dtype=src.dtype, device=src.device)
    idx = pos.clamp(max=cap)[..., None].expand_as(src)
    return out.scatter(-2, idx, src)[..., :cap, :]


def voxel_grid_filter(points: torch.Tensor, valid: torch.Tensor, leaf: float,
                      cap: int, aux: torch.Tensor | None = None):
    """PCL VoxelGrid: one output point per occupied voxel, at the centroid
    of its members, in first-member order.  Grouping by an (N, N) voxel-id
    equality matrix and one matmul for the sums, as the reference does.
    `aux` (..., N, 3) (point normals, for point-to-plane ICP) is averaged
    per voxel the same way, zero in the unused slots: returns (pts, valid,
    aux_out) then, else (pts, valid)."""
    N = points.shape[-2]
    dev = points.device
    vid = _voxel_hash(pad_cloud(points, valid), leaf)
    eq = (vid[..., :, None] == vid[..., None, :]) & valid[..., :, None] & valid[..., None, :]
    earlier = torch.ones((N, N), dtype=torch.bool, device=dev).tril(-1)
    first = valid & ~(eq & earlier).any(dim=-1)
    cnts = eq.sum(dim=-1).to(torch.float32).clamp(min=1.0)[..., None]
    eqf = eq.to(torch.float32)
    centroids = torch.matmul(eqf, torch.where(valid[..., None], points, 0.0)) / cnts
    f = first.to(torch.int64)
    pos = torch.where(first, torch.cumsum(f, dim=-1) - 1, cap)
    ok = torch.arange(cap, device=dev) < f.sum(dim=-1, keepdim=True)
    out_pts = torch.where(ok[..., None], scatter_rows(centroids, pos, cap, SENTINEL),
                          SENTINEL)
    if aux is None:
        return out_pts, ok
    a_cent = torch.matmul(eqf, torch.where(valid[..., None], aux, 0.0)) / cnts
    return out_pts, ok, torch.where(ok[..., None], scatter_rows(a_cent, pos, cap, 0.0), 0.0)


def voxel_occupancy_rate(model_pts: torch.Tensor, model_valid: torch.Tensor,
                         scene_pts: torch.Tensor, scene_valid: torch.Tensor,
                         resolution: float) -> torch.Tensor:
    """Fraction of valid model points whose voxel the scene occupies."""
    sid = torch.where(scene_valid,
                      _voxel_hash(pad_cloud(scene_pts, scene_valid), resolution),
                      2**31 - 1)
    mid = torch.where(model_valid,
                      _voxel_hash(pad_cloud(model_pts, model_valid), resolution),
                      2**31 - 2)
    hit = (mid[..., :, None] == sid[..., None, :]).any(dim=-1) & model_valid
    return hit.sum(dim=-1) / model_valid.sum(dim=-1).clamp(min=1)
