"""Surface normals from a depth image and the depth / normal re-scoring of
a match — the port of ``linemod_pose_estimation_tpu/ops/verification.py``.

``depth_normals`` gives the detection pipeline its per-pixel scene
normals for point-to-plane ICP, once per frame.  ``depth_normal_score``
overlays a template render at a match position and scores

    depth_diff  = mean |depth_template - depth_scene| over the joint valid
                  mask, in metres
    normal_diff = mean angle between scene and template normals there
    score       = exp(-depth_diff) * exp(-normal_diff)

Divisions divide a tensor by a tensor (an IEEE division on every device).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# (dy, dx) of the 8-neighbourhood, in the reference's accumulation order.
_OFFSETS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1))


def depth_normals(depth_mm: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Continuous surface normals from a depth image (H, W) in mm.

    Least-squares plane fit over the 8-neighbourhood (neighbours with a
    depth, within 50 mm of the centre) -> camera-frame unit normals
    (H, W, 3), oriented towards the camera; no depth -> the zero vector."""
    d = depth_mm.to(torch.float32)
    H, W = d.shape
    pd = F.pad(d, (1, 1, 1, 1))
    A00, A01, A11, b0, b1 = (torch.zeros_like(d) for _ in range(5))
    for oy, ox in _OFFSETS:
        nb = pd[oy + 1:oy + 1 + H, ox + 1:ox + 1 + W]
        delta = nb - d
        w = ((nb > 0) & (delta.abs() < 50.0)).to(torch.float32)
        u, v = float(ox), float(oy)
        A00 = A00 + w * u * u
        A01 = A01 + w * u * v
        A11 = A11 + w * v * v
        b0 = b0 + w * u * delta
        b1 = b1 + w * v * delta
    det = A00 * A11 - A01 * A01
    one = torch.ones_like(det)
    inv = torch.where(det.abs() > 1e-6, one / torch.where(det == 0, one, det), 0.0)
    ddx = (A11 * b0 - A01 * b1) * inv  # d(depth)/d(px), mm per px
    ddy = (A00 * b1 - A01 * b0) * inv
    # Surface tangents: t_x = (z/fx, 0, ddx), t_y = (0, z/fy, ddy) (mm).
    zx = d / K[0, 0]
    zy = d / K[1, 1]
    n = torch.stack([-ddx * zy, -ddy * zx, zx * zy], dim=-1)
    norm = torch.sqrt((n * n).sum(dim=-1, keepdim=True))
    n = torch.where(norm > 1e-9, n / norm.clamp(min=1e-9), 0.0)
    n = torch.where(n[..., 2:3] > 0, -n, n)
    return torch.where((d > 0)[..., None], n, 0.0)


def _window(a: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor, E: int) -> torch.Tensor:
    """a[y0:y0 + E, x0:x0 + E] for 0-dim tensor origins, with no host sync."""
    i = torch.arange(E, device=a.device)
    return a[(y0 + i)[:, None], (x0 + i)[None, :]]


def depth_normal_score(scene_depth_mm: torch.Tensor, scene_normals: torch.Tensor,
                       tmpl_depth_mm: torch.Tensor, tmpl_mask: torch.Tensor,
                       tmpl_normals: torch.Tensor, tmpl_rect: torch.Tensor,
                       match_x, match_y, E: int
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(score, depth_diff_m, normal_diff_rad) for one match: the template
    render (full frame + its bbox `tmpl_rect`) overlaid at the scene
    position (match_x, match_y) over an E x E window."""
    H, W = scene_depth_mm.shape
    dev = scene_depth_mm.device
    i64 = lambda v: torch.as_tensor(v, device=dev).long()
    tx = i64(tmpl_rect[0]).clamp(0, max(tmpl_depth_mm.shape[1] - E, 0))
    ty = i64(tmpl_rect[1]).clamp(0, max(tmpl_depth_mm.shape[0] - E, 0))
    td, tm, tn = (_window(a, ty, tx, E) for a in (tmpl_depth_mm, tmpl_mask, tmpl_normals))
    sx = i64(match_x).clamp(0, W - E)
    sy = i64(match_y).clamp(0, H - E)
    sd, sn = _window(scene_depth_mm, sy, sx, E), _window(scene_normals, sy, sx, E)

    joint = (tm > 0) & (sd > 0) & (td > 0)
    n = joint.sum().clamp(min=1)
    thousand = torch.tensor(1000.0, device=dev)
    dd = torch.where(joint, (td - sd).abs(), 0.0).sum() / n / thousand

    ndot = (tn * sn).sum(dim=-1).clamp(-1.0, 1.0)
    length = lambda v: torch.sqrt((v * v).sum(dim=-1))
    have_n = joint & (length(tn) > 0.5) & (length(sn) > 0.5)
    nn = have_n.sum().clamp(min=1)
    nd = torch.where(have_n, torch.arccos(ndot.abs()), 0.0).sum() / nn
    return torch.exp(-dd) * torch.exp(-nd), dd, nd
