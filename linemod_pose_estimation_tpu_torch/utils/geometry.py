"""SE(3) / quaternion / camera utilities in PyTorch — the port of
``linemod_pose_estimation_tpu/utils/geometry.py`` (same conventions, same
f32 expressions).

Quaternion convention: (w, x, y, z), unit norm.  Every function takes
leading batch dimensions where the reference's does.
"""

from __future__ import annotations

import torch


def quat_from_matrix(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) as (w,x,y,z),
    Shepperd's method: the candidate with the largest pivot (the first on
    ties, as jnp.argmax), then w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    pivots = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        dim=-1,
    )
    best = pivots.argmax(dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4 comp, 4 branch)
    idx = best[..., None, None].expand(*best.shape, 4, 1)
    q = torch.gather(cands, -1, idx)[..., 0]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., :1] < 0, -q, q)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) (w,x,y,z) -> rotation matrix (..., 3, 3)."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def quat_average(qs: torch.Tensor, weights: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted mean of quaternions (N, 4), hemisphere-aligned to the first."""
    if weights is None:
        weights = torch.ones(qs.shape[0], dtype=qs.dtype, device=qs.device)
    sign = torch.where((qs * qs[0]).sum(dim=-1, keepdim=True) < 0, -1.0, 1.0)
    q = (qs * sign * weights[:, None]).sum(dim=0)
    n = torch.linalg.vector_norm(q)
    unit = torch.tensor([1.0, 0, 0, 0], dtype=qs.dtype, device=qs.device)
    return torch.where(n > 1e-12, q / n.clamp(min=1e-12), unit)


def rotation_geodesic_deg(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    """Geodesic angle in degrees between rotations (..., 3, 3), atan2 form
    (well-conditioned at small angles)."""
    Rrel = R1.transpose(-1, -2) @ R2
    c = (Rrel.diagonal(dim1=-2, dim2=-1).sum(dim=-1) - 1.0) / 2.0
    sx = Rrel[..., 2, 1] - Rrel[..., 1, 2]
    sy = Rrel[..., 0, 2] - Rrel[..., 2, 0]
    sz = Rrel[..., 1, 0] - Rrel[..., 0, 1]
    s = 0.5 * torch.sqrt(sx * sx + sy * sy + sz * sz)
    return torch.rad2deg(torch.atan2(s, c))


def make_transform(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation + (..., 3) translation -> (..., 4, 4)."""
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a (4, 4) transform to points (..., 3)."""
    return pts @ T[:3, :3].T + T[:3, 3]


def invert_transform(T: torch.Tensor) -> torch.Tensor:
    R = T[:3, :3]
    return make_transform(R.T, -R.T @ T[:3, 3])


def make_K(fx: float, fy: float, cx: float, cy: float,
           dtype=torch.float32, device="cpu") -> torch.Tensor:
    return torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]],
                        dtype=dtype, device=device)


def project(K: torch.Tensor, pts_cam: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (..., 3) -> pixels (..., 2) = (u, v), OpenCV
    convention (x right, y down, z forward)."""
    z = pts_cam[..., 2]
    u = K[0, 0] * pts_cam[..., 0] / z + K[0, 2]
    v = K[1, 1] * pts_cam[..., 1] / z + K[1, 2]
    return torch.stack([u, v], dim=-1)


def look_at_object(eye: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """Object->camera rotation (3, 3) for a camera at `eye` looking at the
    origin, in the bank's convention: rows s (right), -u (down), f
    (forward = normalize(-eye)), with the GL basis s = f x up, u = s x f."""
    fwd = -eye
    fwd = fwd / torch.linalg.vector_norm(fwd)
    s = torch.linalg.cross(fwd, up)
    s = s / torch.linalg.vector_norm(s).clamp(min=1e-12)
    u_gl = torch.linalg.cross(s, fwd)
    return torch.stack([s, -u_gl, fwd], dim=0)
