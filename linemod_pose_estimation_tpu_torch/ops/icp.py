"""Point-to-point ICP over a batch of independent lanes — the port of the
two-stage Kabsch ICP in ``linemod_pose_estimation_tpu/ops/icp.py``
(``icp``, ``icp_two_stage``).

Brute-force nearest neighbours through the centred pairwise-distance
expansion (``utils/pointcloud.py``), distance-gated rejection, and the
closed-form Kabsch update from a 3 x 3 SVD, iterated until the
transform increment falls below `transform_epsilon`.

The reference vmaps a ``lax.while_loop`` over the cluster lanes, which
freezes each lane's state once its own condition fails.  Here the lanes
are one batch with a per-lane ``active`` mask: every iteration updates
only the lanes still running, so each lane stops exactly where the
reference's would.  The loop exits on a host check per iteration.

Numerics kept from the reference: the centred distance expansion, full
f32 matmuls (the package pins TF32 off), the reflection fix in
``_kabsch`` and the per-lane convergence test.  The other ICP variants
(point-to-plane, Levenberg-Marquardt) are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.pointcloud import pairwise_sq_dists


class ICPResult(NamedTuple):
    transform: torch.Tensor  # (..., 4, 4) source -> target
    fitness: torch.Tensor  # (...,) mean squared inlier distance
    num_inliers: torch.Tensor  # (...,) int32
    iterations: torch.Tensor  # (...,) int32
    converged: torch.Tensor  # (...,) bool


def _eye4(lead, device) -> torch.Tensor:
    return torch.eye(4, device=device).expand(*lead, 4, 4).clone()


def _kabsch(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted rigid alignment src -> dst, (..., N, 3) x2 + (..., N) ->
    (..., 4, 4).  A lane with no weight gets the identity (what the
    reference's SVD of the zero matrix gives)."""
    wsum = w.sum(dim=-1).clamp(min=1e-6)[..., None]
    cs = (src * w[..., None]).sum(dim=-2) / wsum
    cd = (dst * w[..., None]).sum(dim=-2) / wsum
    H = ((src - cs[..., None, :]) * w[..., None]).transpose(-1, -2) @ (dst - cd[..., None, :])
    U, _, Vt = torch.linalg.svd(H)
    V, Ut = Vt.transpose(-1, -2), U.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(V @ Ut))
    S = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1))
    R = V @ S @ Ut
    t = cd - (R @ cs[..., None])[..., 0]
    T = _eye4(w.shape[:-1], w.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    none = (w == 0).all(dim=-1)[..., None, None]
    return torch.where(none, torch.eye(4, device=w.device), T)


def _apply(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """pts (..., N, 3) under transforms (..., 4, 4)."""
    return pts @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def icp(model_pts: torch.Tensor, model_valid: torch.Tensor,
        scene_pts: torch.Tensor, scene_valid: torch.Tensor,
        max_iterations: int = 50, max_corr_dist: float = 0.05,
        rejection_dist: float = 0.02, transform_epsilon: float = 1e-5
        ) -> ICPResult:
    """Align model (source) onto scene (target), per lane of the leading
    dimensions; returns the source -> target transform (the pose update
    is ``tf @ pose``)."""
    lead = model_pts.shape[:-2]
    dev = model_pts.device
    gate = min(max_corr_dist * max_corr_dist, rejection_dist * rejection_dist * 4)
    scene_safe = torch.where(scene_valid[..., None], scene_pts, 1e6)
    T = _eye4(lead, dev)
    it = torch.zeros(lead, dtype=torch.int32, device=dev)
    done = torch.zeros(lead, dtype=torch.bool, device=dev)
    fit = torch.full(lead, torch.inf, device=dev)
    ninl = torch.zeros(lead, device=dev)
    eye3 = torch.eye(3, device=dev)
    for _ in range(max_iterations):
        active = ~done
        if not bool(active.any()):
            break
        cur = _apply(T, model_pts)
        d2 = pairwise_sq_dists(cur, scene_safe)
        nn = d2.argmin(dim=-1)  # the first minimum, as jnp.argmin
        nd2 = torch.gather(d2, -1, nn[..., None])[..., 0]
        w = (model_valid & (nd2 < gate)).to(torch.float32)
        tgt = torch.gather(scene_safe, -2, nn[..., None].expand(*nn.shape, 3))
        delta = _kabsch(cur, tgt, w)
        dr = ((delta[..., :3, :3] - eye3) ** 2).sum(dim=(-1, -2))
        dt = (delta[..., :3, 3] ** 2).sum(dim=-1)
        wsum = w.sum(dim=-1)
        a = active[..., None, None]
        T = torch.where(a, delta @ T, T)
        done = torch.where(active, (dr + dt) < transform_epsilon, done)
        fit = torch.where(active, (nd2 * w).sum(dim=-1) / wsum.clamp(min=1.0), fit)
        ninl = torch.where(active, wsum, ninl)
        it = it + active.to(torch.int32)
    return ICPResult(T, fit, ninl.to(torch.int32), it, done)


def icp_two_stage(model_pts: torch.Tensor, model_valid: torch.Tensor,
                  scene_pts: torch.Tensor, scene_valid: torch.Tensor,
                  coarse_iterations: int = 150, coarse_corr_dist: float = 0.05,
                  coarse_rejection: float = 0.02, transform_epsilon: float = 1e-5,
                  fine_iterations: int = 20, fine_corr_dist: float = 0.01,
                  fine_rejection: float = 0.01) -> ICPResult:
    """The reference's coarse + fine ICP schedule (the fine pass converges
    at 1e-6); the composed source -> target transform."""
    r1 = icp(model_pts, model_valid, scene_pts, scene_valid,
             max_iterations=coarse_iterations, max_corr_dist=coarse_corr_dist,
             rejection_dist=coarse_rejection, transform_epsilon=transform_epsilon)
    moved = _apply(r1.transform, model_pts)
    r2 = icp(moved, model_valid, scene_pts, scene_valid,
             max_iterations=fine_iterations, max_corr_dist=fine_corr_dist,
             rejection_dist=fine_rejection, transform_epsilon=1e-6)
    return ICPResult(r2.transform @ r1.transform, r2.fitness, r2.num_inliers,
                     r1.iterations + r2.iterations, r1.converged | r2.converged)
