"""Frozen copy of ``linemod_pose_estimation_tpu_torch/ops/icp.py`` for the
benchmark's plain reference: plain PyTorch only, no hand-written kernel,
imported by nothing of the program, and never edited to follow it.

The original's docstring:

ICP over a batch of independent lanes — the port of
``linemod_pose_estimation_tpu/ops/icp.py``: the Kabsch variant (``icp``,
``icp_two_stage``, ``icp_schedule``), the point-to-plane variant
(``icp_plane``, ``icp_two_stage_plane``) and the Levenberg-Marquardt
variant (``icp_lm``, ``icp_nonlinear_schedule``).

Brute-force nearest neighbours through the centred pairwise-distance
expansion (``utils/pointcloud.py``), distance-gated rejection, and one
update per iteration — the closed-form Kabsch alignment from a 3 x 3 SVD,
a Gauss-Newton step on the point-to-plane objective (6 x 6 solve, with a
small point-to-point term and a trust region), or three damped
Gauss-Newton solves with lambda adaptation — iterated until the transform
increment falls below `transform_epsilon`.

The reference vmaps a ``lax.while_loop`` over the cluster lanes, which
freezes each lane's state once its own condition fails.  Here the lanes
are one batch with a per-lane ``active`` mask: every iteration updates
only the lanes still running, so each lane stops exactly where the
reference's would.  The loop exits on a host check per iteration.

Numerics kept from the reference: the centred distance expansion, full
f32 matmuls and solves (the package pins TF32 off), gates squared in f32,
the reflection fix in ``_kabsch`` and the per-lane convergence test.
Constants divide as tensors (a CUDA division by a host scalar multiplies
by its reciprocal).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .pointcloud import pairwise_sq_dists


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


def _gate2(dist: float) -> np.float32:
    """A gate distance squared in f32, as the reference's traced f32 does."""
    return np.float32(dist) * np.float32(dist)


def _const(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=like.dtype, device=like.device)


def _icp_loop(model_pts, model_valid, scene_pts, scene_valid, max_iterations: int,
              gate, transform_epsilon: float, step) -> ICPResult:
    """The loop the variants share.  Per iteration: move the model, take
    each point's nearest scene point (the first minimum, as jnp.argmin),
    weight by `model_valid & (nd2 < gate)`, and compose
    ``step(cur, tgt, nn, w, active) -> delta (..., 4, 4)`` onto the lanes
    still running; a lane is done once its delta's squared increment falls
    below `transform_epsilon`."""
    lead = model_pts.shape[:-2]
    dev = model_pts.device
    scene_safe = torch.where(scene_valid[..., None], scene_pts, 1e6)
    T = _eye4(lead, dev)
    it = torch.zeros(lead, dtype=torch.int32, device=dev)
    done = torch.zeros(lead, dtype=torch.bool, device=dev)
    fit = torch.full(lead, torch.inf, device=dev)
    ninl = torch.zeros(lead, device=dev)
    eye3 = torch.eye(3, device=dev)
    gate = float(gate)
    for _ in range(max_iterations):
        active = ~done
        if not bool(active.any()):
            break
        cur = _apply(T, model_pts)
        d2 = pairwise_sq_dists(cur, scene_safe)
        nn = d2.argmin(dim=-1)
        nd2 = torch.gather(d2, -1, nn[..., None])[..., 0]
        w = (model_valid & (nd2 < gate)).to(torch.float32)
        tgt = torch.gather(scene_safe, -2, nn[..., None].expand(*nn.shape, 3))
        delta = step(cur, tgt, nn, w, active)
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


def icp(model_pts: torch.Tensor, model_valid: torch.Tensor,
        scene_pts: torch.Tensor, scene_valid: torch.Tensor,
        max_iterations: int = 50, max_corr_dist: float = 0.05,
        rejection_dist: float = 0.02, transform_epsilon: float = 1e-5
        ) -> ICPResult:
    """Align model (source) onto scene (target), per lane of the leading
    dimensions; returns the source -> target transform (the pose update
    is ``tf @ pose``).  Correspondences are gated at the smaller of the
    correspondence distance and twice the rejection distance."""
    gate = min(_gate2(max_corr_dist), _gate2(rejection_dist) * np.float32(4))
    return _icp_loop(model_pts, model_valid, scene_pts, scene_valid, max_iterations,
                     gate, transform_epsilon,
                     lambda cur, tgt, nn, w, active: _kabsch(cur, tgt, w))


def _chain(results) -> ICPResult:
    """Compose passes that each started from the previous one's alignment:
    the product of the transforms, the last pass's fitness and inliers,
    the summed iterations, converged if any pass was."""
    T, iters, conv = results[0].transform, results[0].iterations, results[0].converged
    for r in results[1:]:
        T, iters, conv = r.transform @ T, iters + r.iterations, conv | r.converged
    return ICPResult(T, results[-1].fitness, results[-1].num_inliers, iters, conv)


def icp_schedule(model_pts: torch.Tensor, model_valid: torch.Tensor,
                 scene_pts: torch.Tensor, scene_valid: torch.Tensor,
                 stages) -> ICPResult:
    """A multi-pass Kabsch schedule; each stage is (max_iterations,
    max_corr_dist, rejection_dist, transform_epsilon) and starts from the
    previous stage's alignment."""
    pts, results = model_pts, []
    for max_it, corr, rej, eps in stages:
        results.append(icp(pts, model_valid, scene_pts, scene_valid, max_iterations=max_it,
                           max_corr_dist=corr, rejection_dist=rej, transform_epsilon=eps))
        pts = _apply(results[-1].transform, pts)
    return _chain(results)


def icp_two_stage(model_pts: torch.Tensor, model_valid: torch.Tensor,
                  scene_pts: torch.Tensor, scene_valid: torch.Tensor,
                  coarse_iterations: int = 150, coarse_corr_dist: float = 0.05,
                  coarse_rejection: float = 0.02, transform_epsilon: float = 1e-5,
                  fine_iterations: int = 20, fine_corr_dist: float = 0.01,
                  fine_rejection: float = 0.01) -> ICPResult:
    """The reference's coarse + fine ICP schedule (the fine pass converges
    at 1e-6); the composed source -> target transform."""
    return icp_schedule(model_pts, model_valid, scene_pts, scene_valid, (
        (coarse_iterations, coarse_corr_dist, coarse_rejection, transform_epsilon),
        (fine_iterations, fine_corr_dist, fine_rejection, 1e-6)))


# ---------------------------------------------------------------------------
# Twist steps: point-to-plane Gauss-Newton and Levenberg-Marquardt
# ---------------------------------------------------------------------------


def _point_jacobian(cur: torch.Tensor) -> torch.Tensor:
    """Rows of the point-to-point residual's Jacobian about the identity
    twist (omega, t): (..., N, 3, 6) = [-[cur]_x | I]."""
    x, y, z = cur.unbind(dim=-1)
    o = torch.zeros_like(x)
    cx = torch.stack([torch.stack([o, z, -y], dim=-1), torch.stack([-z, o, x], dim=-1),
                      torch.stack([y, -x, o], dim=-1)], dim=-2)
    eye = torch.eye(3, dtype=cur.dtype, device=cur.device).expand(cx.shape)
    return torch.cat([cx, eye], dim=-1)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum(dim=-1))


def _twist_transform(omega: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) from a rotation vector (Rodrigues) and a translation."""
    th = _norm(omega) + 1e-12
    k = omega / th[..., None]
    o = torch.zeros_like(th)
    K = torch.stack([torch.stack([o, -k[..., 2], k[..., 1]], dim=-1),
                     torch.stack([k[..., 2], o, -k[..., 0]], dim=-1),
                     torch.stack([-k[..., 1], k[..., 0], o], dim=-1)], dim=-2)
    s, c = torch.sin(th)[..., None, None], (1.0 - torch.cos(th))[..., None, None]
    T = _eye4(th.shape, th.device)
    T[..., :3, :3] = torch.eye(3, device=th.device) + s * K + c * (K @ K)
    T[..., :3, 3] = t
    return T


def _p2plane_delta(cur: torch.Tensor, tgt: torch.Tensor, n_tgt: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """One Gauss-Newton step on the point-to-plane objective
    sum w (n . (cur - tgt))^2, linearized about the identity: Jacobian rows
    [cur x n, n].  On a face-on view that system is rank-deficient, so a
    point-to-point term (alpha = 0.1) brings it to full rank, and a trust
    region caps the step at 0.1 rad and 5 cm."""
    alpha = 0.1
    r = (n_tgt * (cur - tgt)).sum(dim=-1)
    Jr = torch.cat([torch.linalg.cross(cur, n_tgt, dim=-1), n_tgt], dim=-1)  # (..., N, 6)
    Jw = Jr * w[..., None]
    JtJ = Jw.transpose(-1, -2) @ Jr
    Jtr = (Jw.transpose(-1, -2) @ r[..., None])[..., 0]
    Jp = _point_jacobian(cur).flatten(-3, -2)  # (..., 3N, 6)
    Jpw = Jp * w.repeat_interleave(3, dim=-1)[..., None]
    rp = (cur - tgt).flatten(-2, -1)
    JtJ = JtJ + alpha * (Jpw.transpose(-1, -2) @ Jp)
    Jtr = Jtr + alpha * (Jpw.transpose(-1, -2) @ rp[..., None])[..., 0]
    A = JtJ + 1e-9 * torch.eye(6, device=cur.device)
    delta = -torch.linalg.solve(A, Jtr[..., None])[..., 0]
    omega, t = delta[..., :3], delta[..., 3:]
    scale = torch.minimum(_const(0.1, cur) / (_norm(omega) + 1e-12),
                          _const(0.05, cur) / (_norm(t) + 1e-12)).clamp(max=1.0)
    return _twist_transform(omega * scale[..., None], t * scale[..., None])


def icp_plane(model_pts: torch.Tensor, model_valid: torch.Tensor,
              scene_pts: torch.Tensor, scene_normals: torch.Tensor,
              scene_valid: torch.Tensor, max_iterations: int = 50,
              max_corr_dist: float = 0.05, rejection_dist: float = 0.02,
              transform_epsilon: float = 1e-5) -> ICPResult:
    """Point-to-plane ICP (one camera-oriented normal per scene point):
    `icp`'s gating and convergence test with the Gauss-Newton plane step.
    Fitness stays the point-to-point mean squared inlier distance."""
    gate = min(_gate2(max_corr_dist), _gate2(rejection_dist) * np.float32(4))

    def step(cur, tgt, nn, w, active):
        n_tgt = torch.gather(scene_normals, -2, nn[..., None].expand(*nn.shape, 3))
        return _p2plane_delta(cur, tgt, n_tgt, w)

    return _icp_loop(model_pts, model_valid, scene_pts, scene_valid, max_iterations,
                     gate, transform_epsilon, step)


def icp_two_stage_plane(model_pts: torch.Tensor, model_valid: torch.Tensor,
                        scene_pts: torch.Tensor, scene_normals: torch.Tensor,
                        scene_valid: torch.Tensor, coarse_iterations: int = 150,
                        coarse_corr_dist: float = 0.05, coarse_rejection: float = 0.02,
                        transform_epsilon: float = 1e-5, fine_iterations: int = 20,
                        fine_corr_dist: float = 0.01, fine_rejection: float = 0.01
                        ) -> ICPResult:
    """`icp_two_stage`'s schedule with the point-to-plane update; both
    passes converge at `transform_epsilon`."""
    r1 = icp_plane(model_pts, model_valid, scene_pts, scene_normals, scene_valid,
                   max_iterations=coarse_iterations, max_corr_dist=coarse_corr_dist,
                   rejection_dist=coarse_rejection, transform_epsilon=transform_epsilon)
    r2 = icp_plane(_apply(r1.transform, model_pts), model_valid, scene_pts, scene_normals,
                   scene_valid, max_iterations=fine_iterations,
                   max_corr_dist=fine_corr_dist, rejection_dist=fine_rejection,
                   transform_epsilon=transform_epsilon)
    return _chain([r1, r2])


def _lm_step(cur: torch.Tensor, tgt: torch.Tensor, w: torch.Tensor,
             lam: torch.Tensor) -> torch.Tensor:
    """One Levenberg-Marquardt solve on the point-to-point objective,
    linearized about the identity: (J^T J + lam diag(J^T J) + 1e-9 I)
    delta = -J^T r, exponentiated to a (..., 4, 4) step."""
    J = _point_jacobian(cur).flatten(-3, -2)  # (..., 3N, 6)
    Jw = J * w.repeat_interleave(3, dim=-1)[..., None]
    r = (cur - tgt).flatten(-2, -1)
    JtJ = Jw.transpose(-1, -2) @ J
    Jtr = (Jw.transpose(-1, -2) @ r[..., None])[..., 0]
    damp = torch.diag_embed(JtJ.diagonal(dim1=-2, dim2=-1))
    A = JtJ + lam[..., None, None] * damp + 1e-9 * torch.eye(6, device=cur.device)
    delta = -torch.linalg.solve(A, Jtr[..., None])[..., 0]
    return _twist_transform(delta[..., :3], delta[..., 3:])


def icp_lm(model_pts: torch.Tensor, model_valid: torch.Tensor,
           scene_pts: torch.Tensor, scene_valid: torch.Tensor,
           max_iterations: int = 50, max_corr_dist: float = 0.05,
           rejection_dist: float = 0.02, transform_epsilon: float = 1e-8,
           lm_iterations: int = 3) -> ICPResult:
    """Levenberg-Marquardt ICP: per correspondence set, `lm_iterations`
    damped solves that compose and re-linearize; an accepted step (lower
    true cost) halves lambda, a rejected one multiplies it by 10, and
    lambda carries over to the next correspondence set.  Correspondences
    must pass both gates: the correspondence distance and the rejection
    distance."""
    gate = min(_gate2(max_corr_dist), _gate2(rejection_dist))
    lead = model_pts.shape[:-2]
    lam = [torch.full(lead, 1e-3, device=model_pts.device)]

    def cost_of(T, cur, tgt, w):
        sq = ((_apply(T, cur) - tgt) ** 2).sum(dim=-1)
        return (sq * w).sum(dim=-1) / w.sum(dim=-1).clamp(min=1.0)

    def step(cur, tgt, nn, w, active):
        T_lm, lam_c = _eye4(lead, cur.device), lam[0]
        cost_c = cost_of(T_lm, cur, tgt, w)
        for _ in range(lm_iterations):
            T_cand = _lm_step(_apply(T_lm, cur), tgt, w, lam_c) @ T_lm
            new_cost = cost_of(T_cand, cur, tgt, w)
            accept = new_cost < cost_c
            T_lm = torch.where(accept[..., None, None], T_cand, T_lm)
            lam_c = torch.where(accept, lam_c * 0.5, lam_c * 10.0)
            cost_c = torch.minimum(new_cost, cost_c)
        lam[0] = torch.where(active, lam_c, lam[0])
        return T_lm

    return _icp_loop(model_pts, model_valid, scene_pts, scene_valid, max_iterations,
                     gate, transform_epsilon, step)


def icp_nonlinear_schedule(model_pts: torch.Tensor, model_valid: torch.Tensor,
                           scene_pts: torch.Tensor, scene_valid: torch.Tensor
                           ) -> ICPResult:
    """The reference's three-pass LM schedule: (50 iterations, corr 0.05,
    rejection 0.02) -> (20, 0.02, 0.01) -> (10, 0.005, 0.01), each at
    epsilon 1e-8 from the previous pass's alignment."""
    pts, results = model_pts, []
    for max_it, corr, rej in ((50, 0.05, 0.02), (20, 0.02, 0.01), (10, 0.005, 0.01)):
        results.append(icp_lm(pts, model_valid, scene_pts, scene_valid,
                              max_iterations=max_it, max_corr_dist=corr,
                              rejection_dist=rej))
        pts = _apply(results[-1].transform, pts)
    return _chain(results)
