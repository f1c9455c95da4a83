"""The post-match detection cascade — the port of the default path of
``linemod_pose_estimation_tpu/models/cascade.py``.

Stage order (the reference's detect_cb):

  matches ──rcd voting──► vote cells (y/step, x/step, depth bin)
          ──cluster filter (drop <= thresh) ──cluster scoring (mean sim)
          ──IoU NMS on averaged bboxes
          ──rough pose: greedy orientation clustering, quaternion and
             translation averaging, re-render at the averaged pose (K4),
             model/scene cloud extraction, SOR + voxel filters,
             surface-centroid position pairing
          ──two-stage Kabsch ICP ──hypothesis verification (voxel
             occupancy) ──pose canonicalization

Variable-size sets are capacity-padded with validity masks, as in the
reference.  Where the reference vmaps one cluster's pose stage over the
cluster lanes, the port runs the lanes as one batch (leading dimension
C): one K4 launch renders every lane, and ICP carries a per-lane active
mask.  The reference's ``lax.cond``s become ``torch.where``s and its
scans Python loops.

Only the default options are ported: two-stage ICP, the surface-centroid
position strategy, one orientation hypothesis, NMS before the pose, no
template-refinement rounds.  Any other value raises NotImplementedError
(``check_ported``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..ops.icp import icp_two_stage
from ..ops.match import Matches, _topk_first_index
from ..utils import geometry as geo
from ..utils import pointcloud as pcu
from .renderer import render as render_fn


@dataclass
class CascadeParams:
    """Knobs of the reference cascade, with the reference's defaults (see
    ``linemod_pose_estimation_tpu/models/cascade.py::CascadeParams`` for
    what each one does)."""

    clustering_step: int = 20
    cluster_filter_thresh: int = 2
    iou_threshold: float = 0.4
    orientation_clustering_th: float = 10.0  # degrees
    icp_max_iter: int = 150
    icp_max_corr_dist: float = 0.05
    icp_tr_epsilon: float = 1e-5
    icp_ransac_thresh: float = 0.02
    icp_fine_iter: int = 20
    icp_fine_corr_dist: float = 0.01
    icp_fine_ransac: float = 0.01
    icp_variant: str = "two_stage"  # the only ported variant
    sor_mean_k: int = 50
    sor_std_mul: float = 1.0
    voxel_leaf: float = 0.002
    hv_resolution: float = 0.004
    hv_threshold: float = 0.30
    enable_hv: bool = False
    canonicalize: str = "x_front"  # "x_front", "z_down" or anything else (none)
    position_strategy: str = "surface_centroid"  # the only ported strategy
    distance_offset_uses_hole: bool = False
    ld_keypoint_leaf: float = 0.008
    ld_descr_radius: float = 0.02
    ld_lrf_radius: float = 0.015
    ld_bin_size: float = 0.01
    ld_keypoint_cap: int = 96
    ld_min_votes: int = 5
    bias_x: int = 0
    render_viewport: int = 256
    refine_rounds: int = 0  # > 0 not ported
    refine_icp_iter: int = 30
    inplane_sweep_deg: float = 6.0
    inplane_sweep: bool = True  # acts only with point-to-plane ICP
    inplane_dominance: float = 0.7
    scene_mask_dilate_px: int = 2
    orientation_hypotheses: int = 1  # > 1 not ported
    nms_after_pose: bool = False  # True not ported
    max_matches: int = 512
    max_cells: int = 64
    members_cap: int = 64
    max_seeds: int = 16
    max_clusters: int = 4
    model_cap: int = 1024
    scene_cap: int = 1024


def check_ported(p: CascadeParams) -> None:
    """Raise NotImplementedError, naming the option, for any non-default
    cascade option this port does not have yet."""
    if p.icp_variant != "two_stage":
        raise NotImplementedError(
            f"icp_variant={p.icp_variant!r} is not ported (only 'two_stage'; "
            "point_to_plane also carries the inplane_sweep repair)")
    if p.position_strategy != "surface_centroid":
        raise NotImplementedError(
            f"position_strategy={p.position_strategy!r} is not ported "
            "(only 'surface_centroid')")
    if p.orientation_hypotheses != 1:
        raise NotImplementedError(
            f"orientation_hypotheses={p.orientation_hypotheses} is not ported (only 1)")
    if p.nms_after_pose:
        raise NotImplementedError("nms_after_pose=True is not ported")
    if p.refine_rounds:
        raise NotImplementedError(f"refine_rounds={p.refine_rounds} is not ported (only 0)")


class ClusterSet(NamedTuple):
    """Vote cells after grouping (the reference's map of vote cell ->
    matches)."""

    score: torch.Tensor  # (C,) mean similarity, -1 where invalid
    count: torch.Tensor  # (C,) int32
    bbox: torch.Tensor  # (C, 4) float32 averaged (x, y, w, h)
    valid: torch.Tensor  # (C,) bool
    member_idx: torch.Tensor  # (C, M) int32 indices into the match arrays
    member_valid: torch.Tensor  # (C, M) bool


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def cluster_matches(matches: Matches, ori_dists: torch.Tensor, rects: torch.Tensor,
                    radius_min: float, radius_step: float, step: int,
                    filter_thresh: int, max_cells: int, members_cap: int
                    ) -> ClusterSet:
    """Vote by (y/step, x/step, depth bin), drop cells with <= thresh
    members, score by mean similarity, average the bboxes; keep the
    `max_cells` biggest cells (the lower index first on equal counts).
    Grouping by a (K, K) cell-equality matrix, as the reference does."""
    K = matches.template_id.shape[0]
    dev = matches.x.device
    valid = matches.valid
    tid = matches.template_id.long()
    depth = ori_dists[tid]
    d_idx = torch.floor((depth - _f32(radius_min, depth)) / _f32(radius_step, depth)
                        ).to(torch.int32)
    hy = torch.div(matches.y, step, rounding_mode="floor")
    hx = torch.div(matches.x, step, rounding_mode="floor")
    cell = ((hy & 1023) << 20) | ((hx & 1023) << 10) | ((d_idx + 32) & 1023)
    cell = torch.where(valid, cell.to(torch.int32), 2**31 - 1)
    eq = (cell[:, None] == cell[None, :]) & valid[:, None] & valid[None, :]
    earlier = torch.ones((K, K), dtype=torch.bool, device=dev).tril(-1)
    first = valid & ~(eq & earlier).any(dim=1)

    wh = rects[tid][:, 2:4].to(torch.float32)
    vals = torch.stack([matches.similarity, matches.x.to(torch.float32),
                        matches.y.to(torch.float32), wh[:, 0], wh[:, 1]], dim=1)
    sums = eq.to(torch.float32) @ torch.where(valid[:, None], vals, 0.0)
    cnt = eq.sum(dim=1).to(torch.float32)
    c = cnt.clamp(min=1.0)
    score = sums[:, 0] / c
    bbox = torch.floor(sums[:, 1:5] / c[:, None])  # integer means, as the reference
    head_valid = first & (cnt > filter_thresh)

    _, rank = _topk_first_index(torch.where(head_valid, cnt, -1.0), max_cells)
    sel_valid = head_valid[rank]
    eq_sel = eq[rank]  # (C, K)
    # Member slot = rank within its cell; members past the cap are dropped
    # (matches arrive best-first, so truncation keeps the best).
    slot = torch.where(eq_sel, torch.cumsum(eq_sel.to(torch.int64), dim=1) - 1,
                       members_cap).clamp(max=members_cap)
    member_idx = torch.zeros((max_cells, members_cap + 1), dtype=torch.int32, device=dev)
    member_idx.scatter_(1, slot, torch.arange(K, dtype=torch.int32, device=dev)
                        .expand(max_cells, K).contiguous())
    member_idx = member_idx[:, :members_cap].contiguous()
    m_cnt = cnt[rank].clamp(max=float(members_cap))
    member_valid = sel_valid[:, None] & (
        torch.arange(members_cap, device=dev)[None, :] < m_cnt[:, None])
    return ClusterSet(
        score=torch.where(sel_valid, score[rank], -1.0),
        count=cnt[rank].to(torch.int32),
        bbox=bbox[rank],
        valid=sel_valid,
        member_idx=member_idx,
        member_valid=member_valid,
    )


def nms_iou(clusters: ClusterSet, iou_threshold: float) -> torch.Tensor:
    """Greedy NMS on the averaged bboxes with inclusive pixel extents:
    walk clusters by descending score (stable), each still-alive one
    suppressing strictly lower-ranked overlaps.  The IoU matrix is
    computed where the clusters live; the short greedy walk runs on the
    host.  Returns the keep mask."""
    x, y, w, h = clusters.bbox.unbind(dim=1)
    x2, y2 = x + w - 1.0, y + h - 1.0
    iw = (torch.minimum(x2[:, None], x2[None, :])
          - torch.maximum(x[:, None], x[None, :]) + 1.0).clamp(min=0.0)
    ih = (torch.minimum(y2[:, None], y2[None, :])
          - torch.maximum(y[:, None], y[None, :]) + 1.0).clamp(min=0.0)
    inter = iw * ih
    union = (w * h)[:, None] + (w * h)[None, :] - inter
    over = (inter / union.clamp(min=1e-6)) > iou_threshold
    order = torch.argsort(-torch.where(clusters.valid, clusters.score, -torch.inf),
                          stable=True)
    over, order = over.cpu().numpy(), order.cpu().numpy()
    keep = clusters.valid.cpu().numpy().copy()
    rank_of = np.empty_like(order)
    rank_of[order] = np.arange(order.shape[0])
    for i, idx in enumerate(order):
        if keep[idx]:
            keep &= ~(over[idx] & (rank_of > i))
    return torch.from_numpy(keep).to(clusters.valid.device)


class ClusterPose(NamedTuple):
    """Per-lane pose results, (C, ...) each."""

    pose: torch.Tensor  # (C, 4, 4) object pose in the camera frame
    rect: torch.Tensor  # (C, 4) int32 (avg match x, avg match y, w, h)
    score: torch.Tensor  # (C,) cluster score
    icp_fitness: torch.Tensor  # (C,)
    hv_rate: torch.Tensor  # (C,)
    valid: torch.Tensor  # (C,) bool
    rough_pose: torch.Tensor  # (C, 4, 4) pre-ICP pose
    hyp_sim: torch.Tensor  # (C,) mean member similarity of the hypothesis


def _orientation_cluster_average(quats, Ts, Ds, Ods, xs, ys, sims, mvalid,
                                 th_deg: float, max_seeds: int, n_hyp: int = 1):
    """Greedy orientation clustering of each lane's members against seeds
    (a member joins the first seed within th_deg, else opens a new one),
    then the averages of the `n_hyp` biggest groups.  Inputs (C, M, ...)
    per lane; returns (q (C, n_hyp, 4), T (C, n_hyp, 3), D, Od, X int32,
    Y int32, sim, cnt) with (C, n_hyp) scalars."""
    C, M = mvalid.shape
    S = max_seeds
    dev = quats.device
    th = torch.deg2rad(_f32(th_deg, quats))
    cos_half_th = torch.cos(th / 2.0)
    seed_q = torch.zeros((C, S, 4), device=dev)
    seed_on = torch.zeros((C, S), dtype=torch.bool, device=dev)
    cnt = torch.zeros((C, S), dtype=torch.int32, device=dev)
    sq = torch.zeros((C, S, 4), device=dev)
    sT = torch.zeros((C, S, 3), device=dev)
    scal = torch.stack([Ds, Ods, xs, ys, sims], dim=0).to(torch.float32)  # (5, C, M)
    s1 = torch.zeros((5, C, S), device=dev)  # sums of D, Od, x, y, sim
    slots = torch.arange(S, device=dev)
    for j in range(M):
        q = quats[:, j]
        dot = (seed_q * q[:, None, :]).sum(dim=-1).abs()
        within = seed_on & (dot > cos_half_th)
        has = within.any(dim=1)
        first = within.to(torch.uint8).argmax(dim=1)
        new_slot = seed_on.sum(dim=1)
        slot = torch.where(has, first, new_slot.clamp(max=S - 1))
        do = mvalid[:, j] & (has | (new_slot < S))
        onehot = (slots[None, :] == slot[:, None]) & do[:, None]
        seed_at = torch.gather(seed_q, 1, slot[:, None, None].expand(C, 1, 4))[:, 0]
        sgn = torch.where((seed_at * q).sum(dim=-1) < 0, -1.0, 1.0)
        q_al = torch.where(has[:, None], sgn[:, None] * q, q)
        opened = onehot & ~has[:, None]
        seed_q = torch.where(opened[..., None], q[:, None, :], seed_q)
        seed_on = seed_on | opened
        cnt = cnt + onehot.to(torch.int32)
        oh = onehot.to(torch.float32)
        sq = sq + oh[..., None] * q_al[:, None, :]
        sT = sT + oh[..., None] * Ts[:, j][:, None, :]
        s1 = s1 + oh[None] * scal[:, :, j][:, :, None]
    top = torch.argsort(-cnt, dim=1, stable=True)[:, :n_hyp]  # biggest first
    cnt_t = torch.gather(cnt, 1, top)
    c = cnt_t.clamp(min=1).to(torch.float32)
    take = lambda a: torch.gather(a, 1, top[..., None].expand(C, n_hyp, a.shape[-1]))
    q_avg = take(sq) / c[..., None]
    qn = torch.sqrt((q_avg * q_avg).sum(dim=-1, keepdim=True))
    unit = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
    q_avg = torch.where(qn > 1e-9, q_avg / qn.clamp(min=1e-9), unit)
    sD, sOd, sx, sy, ssim = (torch.gather(s1[i], 1, top) for i in range(5))
    return (q_avg, take(sT) / c[..., None], sD / c, sOd / c,
            torch.floor(sx / c).to(torch.int32), torch.floor(sy / c).to(torch.int32),
            ssim / c, cnt_t)


def dilate_mask(mask: torch.Tensor, px: int) -> torch.Tensor:
    """4-connected binary dilation of (..., H, W) by `px` pixels, with no
    wraparound at the edges."""
    for _ in range(px):
        out = mask.clone()
        out[..., 1:, :] |= mask[..., :-1, :]
        out[..., :-1, :] |= mask[..., 1:, :]
        out[..., :, 1:] |= mask[..., :, :-1]
        out[..., :, :-1] |= mask[..., :, 1:]
        mask = out
    return mask


def _transplanted_scene_mask_window(mask, rect, X, Y, oy0, ox0, WH: int, WW: int):
    """Each lane's rendered mask (C, mh, mw), cropped at its bbox `rect`
    and placed at (X, Y), seen through a (WH, WW) window whose scene
    origin is (oy0, ox0): win(wy, wx) = mask(oy0 + wy - Y + r1,
    ox0 + wx - X + r0), zero outside the mask.  The reference's paste
    into a zero canvas + dynamic slice, including the slice's clamp of
    its start, as a direct gather."""
    C, mh, mw = mask.shape
    dev = mask.device
    oy = (WH + mh + oy0 - Y + rect[:, 1]).clamp(0, WH + 2 * mh) - (WH + mh)
    ox = (WW + mw + ox0 - X + rect[:, 0]).clamp(0, WW + 2 * mw) - (WW + mw)
    rows = oy[:, None] + torch.arange(WH, device=dev)[None, :]
    cols = ox[:, None] + torch.arange(WW, device=dev)[None, :]
    ok = (((rows >= 0) & (rows < mh))[:, :, None]
          & ((cols >= 0) & (cols < mw))[:, None, :])
    lane = torch.arange(C, device=dev)[:, None, None]
    m = mask[lane, rows.clamp(0, mh - 1)[:, :, None], cols.clamp(0, mw - 1)[:, None, :]]
    return (m > 0) & ok


def _compact_points(pts_flat: torch.Tensor, sel_flat: torch.Tensor, cap: int):
    """Compact up to `cap` selected points per lane ((C, N, 3), (C, N)) in
    raster order; with more than `cap` selected, keep every k-th (k =
    ceil(n / cap)) so the subset covers the whole mask.  Returns (pts
    (C, cap, 3), valid (C, cap))."""
    s = sel_flat.to(torch.int64)
    n = s.sum(dim=-1, keepdim=True)
    k = torch.div(n + cap - 1, cap, rounding_mode="floor").clamp(min=1)
    sel = sel_flat & ((torch.cumsum(s, dim=-1) - 1) % k == 0)
    s2 = sel.to(torch.int64)
    pos = torch.where(sel, torch.cumsum(s2, dim=-1) - 1, cap)
    pts = pcu.scatter_rows(pts_flat.to(torch.float32), pos, cap, pcu.SENTINEL)
    valid = torch.arange(cap, device=pts.device) < s2.sum(dim=-1, keepdim=True)
    return torch.where(valid[..., None], pts, pcu.SENTINEL), valid


def _windowed_scene_extract(cloud, mask, rect, X, Y, dilate_px: int, cap: int):
    """Transplant each lane's mask at (X, Y), dilate, and compact the
    masked finite scene points — inside a (mh + pad, mw + pad) window
    around the transplant, so the per-pixel work scales with the object.
    cloud (H, W, 3) is shared by the lanes.  Returns (pts, valid)."""
    H, W, _ = cloud.shape
    C, mh, mw = mask.shape
    dev = cloud.device
    pad = 2 * dilate_px + 8
    WH, WW = min(H, mh + pad), min(W, mw + pad)
    oy0 = (Y - pad // 2).clamp(0, H - WH)
    ox0 = (X - pad // 2).clamp(0, W - WW)
    win = _transplanted_scene_mask_window(mask, rect, X, Y, oy0, ox0, WH, WW)
    win = dilate_mask(win, dilate_px)
    rows = oy0[:, None] + torch.arange(WH, device=dev)[None, :]
    cols = ox0[:, None] + torch.arange(WW, device=dev)[None, :]
    cloud_w = cloud[rows[:, :, None], cols[:, None, :]]  # (C, WH, WW, 3)
    sel = win & torch.isfinite(cloud_w).all(dim=-1)
    return _compact_points(cloud_w.reshape(C, -1, 3), sel.reshape(C, -1), cap)


def canonicalize(R: torch.Tensor, mode: str) -> torch.Tensor:
    """Pose canonicalization of rotations (..., 3, 3): "x_front" (flip so
    that R[0, 0] >= 0 and R[1, 1] <= 0, keeping a right-handed frame),
    "z_down" (flip x and z when R[2, 2] < 0), anything else unchanged."""
    one = torch.ones_like(R[..., 0, 0])
    if mode == "x_front":
        c0, c1 = R[..., 0, 0] < 0, R[..., 1, 1] > 0
        s = torch.stack([torch.where(c0, -one, one), torch.where(c1, -one, one),
                         torch.where(c0 ^ c1, -one, one)], dim=-1)
    elif mode == "z_down":
        f = torch.where(R[..., 2, 2] < 0, -one, one)
        s = torch.stack([f, one, f], dim=-1)
    else:
        return R
    return R * s[..., None, :]


def rough_pose_and_refine(member_quats, member_T, member_D, member_Od, member_x,
                          member_y, member_sims, member_valid, cluster_valid,
                          cluster_score, cloud: torch.Tensor, triangles: torch.Tensor,
                          K_render: torch.Tensor, params: CascadeParams,
                          render_wh: tuple[int, int]) -> ClusterPose:
    """Rough pose, surface-centroid pairing, two-stage ICP, verification
    and canonicalization for C cluster lanes at once (member arrays (C,
    M, ...), cluster arrays (C,), cloud (H, W, 3) in metres)."""
    check_ported(params)
    H, W = cloud.shape[:2]
    C = cluster_valid.shape[0]
    dev = cloud.device
    rw, rh = render_wh
    hq, hT, hD, hOd, hX, hY, hsim, hcnt = (
        a[:, 0] for a in _orientation_cluster_average(
            member_quats, member_T, member_D, member_Od, member_x, member_y,
            member_sims, member_valid, params.orientation_clustering_th,
            params.max_seeds, n_hyp=1))
    R_avg = geo.quat_to_matrix(hq)
    # A lane without a cluster gets no model points: its ICP delta is the
    # identity from the first iteration.
    active = cluster_valid & (hcnt > 0)

    # Re-render at the averaged pose.  The object projects at the
    # principal point, so a centred VP x VP window (principal point moved
    # to VP/2) rasterizes the same rays at a fraction of the pixels.
    vp = params.render_viewport
    if vp and vp < min(rw, rh):
        K_r = K_render.clone()
        K_r[0, 2] = K_r[1, 2] = vp / 2.0
        r_w = r_h = vp
    else:
        K_r, r_w, r_h = K_render, rw, rh
    out = render_fn(triangles, R_avg, hT, K_r.expand(C, 3, 3), r_w, r_h)

    # Model cloud: the rendered view back-projected and masked.
    mcloud = pcu.depth_to_cloud(pcu.true_div(out.depth_mm, 1000.0), K_r)
    msel = ((out.mask > 0) & torch.isfinite(mcloud).all(dim=-1)
            & active[:, None, None])
    model_pts, model_valid = _compact_points(mcloud.reshape(C, -1, 3),
                                             msel.reshape(C, -1), params.model_cap)

    # Scene cloud: the rendered mask transplanted to the detected (X, Y).
    scene_pts, scene_valid = _windowed_scene_extract(
        cloud, out.mask, out.rect, hX + params.bias_x, hY,
        params.scene_mask_dilate_px, params.scene_cap)
    scene_valid = pcu.statistical_outlier_removal(
        scene_pts, scene_valid, params.sor_mean_k, params.sor_std_mul)
    scene_pts, scene_valid = pcu.voxel_grid_filter(
        scene_pts, scene_valid, params.voxel_leaf, params.scene_cap)
    model_pts, model_valid = pcu.voxel_grid_filter(
        model_pts, model_valid, params.voxel_leaf, params.model_cap)

    # Surface-centroid pairing: the model's surface point nearest its
    # centroid lands on the scene's.
    s_surf = pcu.nearest_point(scene_pts, scene_valid,
                               pcu.masked_centroid(scene_pts, scene_valid))
    m_surf = pcu.nearest_point(model_pts, model_valid,
                               pcu.masked_centroid(model_pts, model_valid))
    tshift = s_surf - m_surf
    zero = torch.zeros_like(hOd)
    pose0 = geo.make_transform(R_avg, torch.stack([zero, zero, hOd], dim=-1) + tshift)
    model_pts_t = model_pts + tshift[:, None, :]

    icp_res = icp_two_stage(
        model_pts_t, model_valid, scene_pts, scene_valid,
        coarse_iterations=params.icp_max_iter,
        coarse_corr_dist=params.icp_max_corr_dist,
        coarse_rejection=params.icp_ransac_thresh,
        transform_epsilon=params.icp_tr_epsilon,
        fine_iterations=params.icp_fine_iter,
        fine_corr_dist=params.icp_fine_corr_dist,
        fine_rejection=params.icp_fine_ransac,
    )
    Ti = icp_res.transform
    pose = Ti @ pose0
    model_final = model_pts_t @ Ti[:, :3, :3].transpose(-1, -2) + Ti[:, None, :3, 3]

    hv_rate = pcu.voxel_occupancy_rate(model_final, model_valid, scene_pts,
                                       scene_valid, params.hv_resolution)
    hv_ok = hv_rate >= params.hv_threshold if params.enable_hv else True
    pose = pose.clone()
    pose[:, :3, :3] = canonicalize(pose[:, :3, :3], params.canonicalize)
    rect = torch.stack([hX, hY, out.rect[:, 2], out.rect[:, 3]], dim=-1).to(torch.int32)
    ok = (cluster_valid & hv_ok & (scene_valid.sum(dim=-1) > 10)
          & (model_valid.sum(dim=-1) > 10) & (icp_res.num_inliers > 0))
    return ClusterPose(pose=pose, rect=rect, score=cluster_score,
                       icp_fitness=icp_res.fitness, hv_rate=hv_rate, valid=ok,
                       rough_pose=pose0, hyp_sim=hsim)
