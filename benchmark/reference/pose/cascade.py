"""Frozen copy of ``linemod_pose_estimation_tpu_torch/models/cascade.py`` for the
benchmark's plain reference: plain PyTorch only, no hand-written kernel,
imported by nothing of the program, and never edited to follow it.

The original's docstring:

The post-match detection cascade — the port of
``linemod_pose_estimation_tpu/models/cascade.py``.

Stage order (the reference's detect_cb):

  matches ──rcd voting──► vote cells (y/step, x/step, depth bin)
          ──cluster filter (drop <= thresh) ──cluster scoring (mean sim)
          ──IoU NMS on averaged bboxes (or, with nms_after_pose, on the
             posed rects ranked by verification: ``nms_rects``)
          ──rough pose: greedy orientation clustering, quaternion and
             translation averaging of the biggest group (or of the two
             biggest: orientation_hypotheses = 2), re-render at the
             averaged pose (K4), model/scene cloud extraction, SOR + voxel
             filters, the position strategy (surface centroid, ROI centre,
             distance offset, or the local-descriptor pose)
          ──ICP (two-stage Kabsch, point-to-plane with the in-plane sweep
             repair, or the Levenberg-Marquardt schedule)
          ──template-refinement rounds (an off-axis re-render at the
             refined pose, the scene re-extracted, ICP again)
          ──hypothesis verification (voxel occupancy) ──pose
             canonicalization ──hypothesis selection

Variable-size sets are capacity-padded with validity masks, as in the
reference.  Where the reference vmaps one cluster's pose stage over the
cluster lanes, and one hypothesis's over the hypotheses, the port runs
them as one batch of C * n_hyp lanes (lane = cluster * n_hyp +
hypothesis): one K4 launch renders every lane, and ICP carries a per-lane
active mask.  The reference's ``lax.cond``s become ``torch.where``s and
its scans Python loops.  Its debugging switches read from the environment
are not carried over.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from .filters import greedy_suppress
from .icp import (_apply, icp_nonlinear_schedule, icp_two_stage,
                       icp_two_stage_plane)
from ..matcher import Matches, _topk_first_index
from . import geometry as geo
from . import pointcloud as pcu
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
    icp_variant: str = "two_stage"  # or "point_to_plane", "nonlinear"
    sor_mean_k: int = 50
    sor_std_mul: float = 1.0
    voxel_leaf: float = 0.002
    hv_resolution: float = 0.004
    hv_threshold: float = 0.30
    enable_hv: bool = False
    canonicalize: str = "x_front"  # "x_front", "z_down" or anything else (none)
    # "surface_centroid", "roi_center", "distance_offset", "local_descriptor"
    position_strategy: str = "surface_centroid"
    distance_offset_uses_hole: bool = False
    ld_keypoint_leaf: float = 0.008
    ld_descr_radius: float = 0.02
    ld_lrf_radius: float = 0.015
    ld_bin_size: float = 0.01
    ld_keypoint_cap: int = 96
    ld_min_votes: int = 5
    bias_x: int = 0
    render_viewport: int = 256
    refine_rounds: int = 0
    refine_icp_iter: int = 30
    inplane_sweep_deg: float = 6.0
    inplane_sweep: bool = True  # acts only with point-to-plane ICP
    inplane_dominance: float = 0.7
    scene_mask_dilate_px: int = 2
    orientation_hypotheses: int = 1
    nms_after_pose: bool = False
    max_matches: int = 512
    max_cells: int = 64
    members_cap: int = 64
    max_seeds: int = 16
    max_clusters: int = 4
    model_cap: int = 1024
    scene_cap: int = 1024


# The reference's accuracy configuration (what its command line's
# --accuracy sets): point-to-plane ICP with the in-plane sweep repair, the
# runner-up orientation group posed and verified too, NMS after the pose.
ACCURACY_OPTIONS = dict(icp_variant="point_to_plane", orientation_hypotheses=2,
                        nms_after_pose=True)

# The non-default configurations that tests/data/torch_cascade_options_golden.npz
# holds the reference's answers for (tools/make_torch_cascade_golden.py):
# name -> (CascadeParams overrides, frames of the cascade golden it ran on).
GOLDEN_OPTION_SETS = {
    "accuracy": (ACCURACY_OPTIONS, (0, 1, 2, 3)),
    "accuracy_refine": (dict(ACCURACY_OPTIONS, refine_rounds=1), (0,)),
    "nonlinear": (dict(icp_variant="nonlinear"), (0,)),
    "roi_center": (dict(position_strategy="roi_center"), (0,)),
    "distance_offset": (dict(position_strategy="distance_offset"), (0,)),
    "local_descriptor": (dict(position_strategy="local_descriptor"), (0,)),
}


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


def _greedy_nms(x, y, w, h, key: torch.Tensor, valid: torch.Tensor,
                iou_threshold: float) -> torch.Tensor:
    """Greedy NMS over boxes (x, y, w, h as f32 (C,)) with inclusive pixel
    extents: walk them by descending `key` (stable: ties keep the lower
    index first), each still-alive one suppressing strictly lower-ranked
    overlaps (``ops.filters.greedy_suppress``).  Returns the keep mask."""
    x2, y2 = x + w - 1.0, y + h - 1.0
    iw = (torch.minimum(x2[:, None], x2[None, :])
          - torch.maximum(x[:, None], x[None, :]) + 1.0).clamp(min=0.0)
    ih = (torch.minimum(y2[:, None], y2[None, :])
          - torch.maximum(y[:, None], y[None, :]) + 1.0).clamp(min=0.0)
    inter = iw * ih
    union = (w * h)[:, None] + (w * h)[None, :] - inter
    over = (inter / union.clamp(min=1e-6)) > iou_threshold
    return greedy_suppress(over, key, valid)


def nms_iou(clusters: ClusterSet, iou_threshold: float) -> torch.Tensor:
    """Greedy NMS on the clusters' averaged bboxes, ranked by score.
    Returns the keep mask."""
    return _greedy_nms(*clusters.bbox.unbind(dim=1), clusters.score, clusters.valid,
                       iou_threshold)


def nms_rects(rects: torch.Tensor, key: torch.Tensor, valid: torch.Tensor,
              iou_threshold: float) -> torch.Tensor:
    """Greedy NMS over (C, 4) int rects ranked by `key` (descending): the
    pose-aware variant, which ranks overlapping posed clusters by
    verification instead of match score.  Returns the keep mask."""
    return _greedy_nms(*rects.to(torch.float32).unbind(dim=1), key, valid, iou_threshold)


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


def _transplanted_scene_mask(mask: torch.Tensor, rect, X, Y, H: int, W: int) -> torch.Tensor:
    """One rendered mask (mh, mw), cropped at its bbox `rect` (4,) and
    placed at (X, Y) in an (H, W) scene: the window variant above with
    the whole frame as its window, which clamps the start of the
    reference's canvas slice the same way."""
    dev = mask.device
    lane = lambda v: torch.as_tensor(v, dtype=torch.int64, device=dev).reshape(1)
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    rect = torch.as_tensor(rect, device=dev).to(torch.int64).reshape(1, 4)
    return _transplanted_scene_mask_window(mask[None], rect, lane(X), lane(Y), zero, zero,
                                           H, W)[0]


def _compact_points(pts_flat: torch.Tensor, sel_flat: torch.Tensor, cap: int,
                    aux_flat: torch.Tensor | None = None):
    """Compact up to `cap` selected points per lane ((C, N, 3), (C, N)) in
    raster order; with more than `cap` selected, keep every k-th (k =
    ceil(n / cap)) so the subset covers the whole mask.  Returns (pts
    (C, cap, 3), valid (C, cap)); with `aux_flat` (C, N, 3) (per-point
    normals), also the rows of it at the same selection, zero elsewhere."""
    s = sel_flat.to(torch.int64)
    n = s.sum(dim=-1, keepdim=True)
    k = torch.div(n + cap - 1, cap, rounding_mode="floor").clamp(min=1)
    sel = sel_flat & ((torch.cumsum(s, dim=-1) - 1) % k == 0)
    s2 = sel.to(torch.int64)
    pos = torch.where(sel, torch.cumsum(s2, dim=-1) - 1, cap)
    pts = pcu.scatter_rows(pts_flat.to(torch.float32), pos, cap, pcu.SENTINEL)
    valid = torch.arange(cap, device=pts.device) < s2.sum(dim=-1, keepdim=True)
    pts = torch.where(valid[..., None], pts, pcu.SENTINEL)
    if aux_flat is None:
        return pts, valid
    aux = pcu.scatter_rows(aux_flat.to(torch.float32), pos, cap, 0.0)
    return pts, valid, torch.where(valid[..., None], aux, 0.0)


def _windowed_scene_extract(cloud, mask, rect, X, Y, dilate_px: int, cap: int,
                            scene_normals: torch.Tensor | None = None):
    """Transplant each lane's mask at (X, Y), dilate, and compact the
    masked finite scene points — inside a (mh + pad, mw + pad) window
    around the transplant, so the per-pixel work scales with the object.
    cloud (H, W, 3), and scene_normals (H, W, 3) where given, are shared by
    the lanes.  Returns (pts, valid, normals or None)."""
    H, W, _ = cloud.shape
    C, mh, mw = mask.shape
    dev = cloud.device
    pad = 2 * dilate_px + 8
    WH, WW = min(H, mh + pad), min(W, mw + pad)
    oy0 = (Y - pad // 2).clamp(0, H - WH)
    ox0 = (X - pad // 2).clamp(0, W - WW)
    win = _transplanted_scene_mask_window(mask, rect, X, Y, oy0, ox0, WH, WW)
    win = dilate_mask(win, dilate_px)
    rows = (oy0[:, None] + torch.arange(WH, device=dev)[None, :])[:, :, None]
    cols = (ox0[:, None] + torch.arange(WW, device=dev)[None, :])[:, None, :]
    cloud_w = cloud[rows, cols]  # (C, WH, WW, 3)
    sel = (win & torch.isfinite(cloud_w).all(dim=-1)).reshape(C, -1)
    if scene_normals is None:
        return (*_compact_points(cloud_w.reshape(C, -1, 3), sel, cap), None)
    return _compact_points(cloud_w.reshape(C, -1, 3), sel, cap,
                           scene_normals[rows, cols].reshape(C, -1, 3))


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


# ---------------------------------------------------------------------------
# The in-plane sweep repair of point-to-plane ICP
# ---------------------------------------------------------------------------

PLANE_EPS = 5e-3  # m; points this close to the median plane depth count as the face
SWEEP_COARSE, SWEEP_FINE = 181, 21  # angles over +-45 degrees, then over +-0.5


def _linspace(start: float, stop: float, num: int, device) -> torch.Tensor:
    """jnp.linspace's f32 expression: start * (1 - i / (num - 1)) + stop *
    (i / (num - 1)) for i < num - 1, then stop itself."""
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=device) / torch.tensor(
        float(div), device=device)
    out = torch.tensor(start, device=device) * (1 - step) + torch.tensor(stop, device=device) * step
    return torch.cat([out, torch.tensor([stop], dtype=torch.float32, device=device)])


def _median(values: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Median of the valid entries along the last dim, the mean of the two
    middle ones for an even count (numpy's and jnp.nanmedian's rule;
    torch.nanmedian would return the lower one); NaN with no valid entry."""
    n = valid.sum(dim=-1, keepdim=True)
    srt = torch.sort(torch.where(valid, values, torch.inf), dim=-1).values
    lo = torch.gather(srt, -1, (torch.div(n - 1, 2, rounding_mode="floor")).clamp(min=0))
    hi = torch.gather(srt, -1, torch.div(n, 2, rounding_mode="floor").clamp(
        max=values.shape[-1] - 1))
    return torch.where(n > 0, lo * 0.5 + hi * 0.5, torch.nan)[..., 0]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(dim=-1)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.sqrt(_dot(v, v)).clamp(min=1e-9)[..., None]


def _rectangle_orientation(pts, valid, n_dom, e1, e2):
    """(bbox angle, bbox dims at that angle, area modulation) of each
    lane's points on its dominant plane: a min-area bounding-box sweep
    over +-45 degrees, then +-0.5 around the best."""
    depth = _dot(pts, n_dom[..., None, :])
    med = _median(depth, valid)
    keep = valid & ((depth - med[..., None]).abs() < PLANE_EPS)
    cnt = keep.sum(dim=-1).clamp(min=1)
    q = torch.stack([_dot(pts, e1[..., None, :]), _dot(pts, e2[..., None, :])], dim=-1)
    cq = torch.where(keep[..., None], q, 0.0).sum(dim=-2) / cnt[..., None]
    qc = q - cq[..., None, :]

    def dims(th):  # th (..., A) -> (..., A, 2)
        c, s = torch.cos(th)[..., None], torch.sin(th)[..., None]
        qx, qy = qc[..., None, :, 0], qc[..., None, :, 1]
        x = qx * c + qy * s
        y = -qx * s + qy * c
        k = keep[..., None, :]
        span = lambda v: (torch.where(k, v, -torch.inf).amax(dim=-1)
                          - torch.where(k, v, torch.inf).amin(dim=-1))
        return torch.stack([span(x), span(y)], dim=-1)

    def best_of(angles):
        d = dims(angles)
        area = d[..., 0] * d[..., 1]
        i = area.argmin(dim=-1, keepdim=True)
        return torch.gather(angles, -1, i)[..., 0], area

    dev = pts.device
    a1s = _linspace(-torch.pi / 4.0, torch.pi / 4.0, SWEEP_COARSE, dev).expand(
        *valid.shape[:-1], SWEEP_COARSE)
    b1, ar1 = best_of(a1s)
    b2, _ = best_of(b1[..., None] + _linspace(-torch.pi / 360.0, torch.pi / 360.0,
                                              SWEEP_FINE, dev))
    modulation = ar1.amax(dim=-1) / ar1.amin(dim=-1).clamp(min=1e-12)
    return b2, dims(b2[..., None])[..., 0, :], modulation


def inplane_sweep_fix(model_pts: torch.Tensor, model_valid: torch.Tensor,
                      scene_pts: torch.Tensor, scene_n: torch.Tensor,
                      scene_valid: torch.Tensor, active: torch.Tensor,
                      sweep_deg: float, dominance: float
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Rank-deficiency repair for point-to-plane ICP (the face-on tail).

    When one plane dominates the visible scene surface, the point-to-plane
    normal equations are blind to rotation about its normal, so an in-plane
    offset of the initial pose survives ICP.  The repair recovers it in
    closed form: the mode scene normal by mean-shift (4 rounds over the
    sign-folded normals within ~25 degrees), both clouds projected onto
    that face's plane (points within 5 mm of the median plane depth), each
    cloud's rectangle orientation by a min-area bounding-box sweep, and the
    model rotated about the mode normal through its centroid by the
    orientation difference (wrapped to +-45 degrees).

    Applied only where the lane is active, the fraction of scene normals
    aligned with the mode exceeds `dominance`, both sweeps are modulated
    (> 5 % area swing), the two oriented-bbox dimensions agree within 10 %,
    and 0.25 degrees <= |angle| <= sweep_deg.  Per lane of the leading
    dimensions; returns (T_fix (..., 4, 4), applied (...,)), T_fix the
    identity where not applied."""
    n_dom = _unit(pcu.masked_centroid(scene_n, scene_valid))
    for _ in range(4):
        dots = _dot(scene_n, n_dom[..., None, :])
        w = scene_valid & (dots.abs() > 0.9)
        cand = torch.where(w[..., None], scene_n * torch.sign(dots)[..., None], 0.0).sum(dim=-2)
        ok = torch.sqrt(_dot(cand, cand)) > 1e-9
        n_dom = torch.where(ok[..., None], _unit(cand), n_dom)
    aligned = scene_valid & (_dot(scene_n, n_dom[..., None, :]).abs() > 0.9)
    dom_frac = aligned.to(torch.float32).sum(dim=-1) / scene_valid.sum(dim=-1).clamp(min=1)
    deficient = dom_frac > dominance
    c0 = pcu.masked_centroid(model_pts, model_valid)

    ex = torch.tensor([1.0, 0.0, 0.0], device=n_dom.device)
    ey = torch.tensor([0.0, 1.0, 0.0], device=n_dom.device)
    seed = torch.where((n_dom[..., :1].abs() < 0.9), ex, ey)
    e1 = _unit(torch.linalg.cross(n_dom, seed, dim=-1))
    e2 = torch.linalg.cross(n_dom, e1, dim=-1)

    ang_m, dims_m, mod_m = _rectangle_orientation(model_pts, model_valid, n_dom, e1, e2)
    ang_s, dims_s, mod_s = _rectangle_orientation(scene_pts, scene_valid, n_dom, e1, e2)
    mod_ok = (mod_m > 1.05) & (mod_s > 1.05)
    dims_ok = ((dims_m - dims_s).abs()
               < 0.1 * torch.maximum(dims_m, dims_s).clamp(min=1e-6)).all(dim=-1)
    quarter = torch.pi / 2.0
    best = torch.remainder(ang_s - ang_m + quarter / 2, quarter) - quarter / 2
    cap = sweep_deg * torch.pi / 180.0
    min_fix = 0.25 * torch.pi / 180.0
    applied = (active & deficient & dims_ok & mod_ok
               & (best.abs() <= cap) & (best.abs() >= min_fix))

    o = torch.zeros_like(best)
    Kx = torch.stack([torch.stack([o, -n_dom[..., 2], n_dom[..., 1]], dim=-1),
                      torch.stack([n_dom[..., 2], o, -n_dom[..., 0]], dim=-1),
                      torch.stack([-n_dom[..., 1], n_dom[..., 0], o], dim=-1)], dim=-2)
    th = torch.where(applied, best, 0.0)[..., None, None]
    Rb = (torch.eye(3, device=n_dom.device) + torch.sin(th) * Kx
          + (1 - torch.cos(th)) * (Kx @ Kx))
    return geo.make_transform(Rb, c0 - (Rb @ c0[..., None])[..., 0]), applied


# ---------------------------------------------------------------------------
# Rough pose + refinement
# ---------------------------------------------------------------------------


def _z_offset(z: torch.Tensor) -> torch.Tensor:
    """(L,) -> (L, 3) translations (0, 0, z)."""
    o = torch.zeros_like(z)
    return torch.stack([o, o, z], dim=-1)


def _scene_cloud(cloud, scene_normals, mask, rect, X, Y, params: CascadeParams):
    """The scene side of one ICP: the mask transplanted at (X, Y), the
    masked points compacted, outliers removed, voxel-filtered; with
    `scene_normals`, each voxel's mean normal renormalized.  Returns
    (pts, valid, normals or None)."""
    pts, valid, nrm = _windowed_scene_extract(
        cloud, mask, rect, X, Y, params.scene_mask_dilate_px, params.scene_cap,
        scene_normals=scene_normals)
    valid = pcu.statistical_outlier_removal(pts, valid, params.sor_mean_k,
                                            params.sor_std_mul)
    if nrm is None:
        return (*pcu.voxel_grid_filter(pts, valid, params.voxel_leaf, params.scene_cap), None)
    pts, valid, nrm = pcu.voxel_grid_filter(pts, valid, params.voxel_leaf,
                                            params.scene_cap, aux=nrm)
    return pts, valid, nrm / torch.sqrt(_dot(nrm, nrm)).clamp(min=1e-9)[..., None]


def _model_cloud(render_out, K, active, params: CascadeParams):
    """The model side: the rendered view back-projected under K, masked,
    compacted and voxel-filtered; a lane that is not active gets no
    points, so its ICP delta is the identity from the first iteration."""
    L = active.shape[0]
    mcloud = pcu.depth_to_cloud(pcu.true_div(render_out.depth_mm, 1000.0), K)
    msel = ((render_out.mask > 0) & torch.isfinite(mcloud).all(dim=-1)
            & active[:, None, None])
    pts, valid = _compact_points(mcloud.reshape(L, -1, 3), msel.reshape(L, -1),
                                 params.model_cap)
    return pcu.voxel_grid_filter(pts, valid, params.voxel_leaf, params.model_cap)


def _two_stage(params: CascadeParams, model, mvalid, scene, scene_n, svalid, **coarse):
    """Two-stage ICP with the cascade's fine pass: point-to-plane where the
    scene has normals, else Kabsch."""
    kw = dict(**coarse, transform_epsilon=params.icp_tr_epsilon,
              fine_iterations=params.icp_fine_iter, fine_corr_dist=params.icp_fine_corr_dist,
              fine_rejection=params.icp_fine_ransac)
    if scene_n is not None:
        return icp_two_stage_plane(model, mvalid, scene, scene_n, svalid, **kw)
    return icp_two_stage(model, mvalid, scene, svalid, **kw)


def _pose_lanes(q_avg, T_aver, D_aver, Trans_aver, X, Y, hyp_sim, hyp_on, cluster_valid,
                cluster_score, cloud, triangles, K_render, params: CascadeParams,
                render_wh, scene_normals) -> ClusterPose:
    """Render + position strategy + ICP + refinement rounds + verification
    for L lanes, each one orientation hypothesis of one cluster.
    `scene_normals` is None unless the lanes run point-to-plane ICP."""
    H, W = cloud.shape[:2]
    L = cluster_valid.shape[0]
    rw, rh = render_wh
    R_avg = geo.quat_to_matrix(q_avg)
    active = cluster_valid & hyp_on

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
    out = render_fn(triangles, R_avg, T_aver, K_r.expand(L, 3, 3), r_w, r_h)
    model_pts, model_valid = _model_cloud(out, K_r, active, params)
    # Scene cloud: the rendered mask transplanted to the detected (X, Y).
    Xb = X + params.bias_x
    scene_pts, scene_valid, scene_n = _scene_cloud(cloud, scene_normals, out.mask,
                                                   out.rect, Xb, Y, params)

    # Initial pose: the averaged rotation, z = the averaged distance.
    z0 = _z_offset(Trans_aver)
    surface_shift = lambda: (
        pcu.nearest_point(scene_pts, scene_valid, pcu.masked_centroid(scene_pts, scene_valid))
        - pcu.nearest_point(model_pts, model_valid,
                            pcu.masked_centroid(model_pts, model_valid)))
    strategy = params.position_strategy
    ld_valid = None
    if strategy in ("roi_center", "distance_offset"):
        # The scene point at the detection ROI's centre (where it has no
        # depth: the scene cloud's point nearest its centroid, or the
        # centroid itself).
        cy = (Y + out.rect[:, 3] // 2).clamp(0, H - 1).long()
        cx = (Xb + out.rect[:, 2] // 2).clamp(0, W - 1).long()
        scene_pt = cloud[cy, cx]
        centroid = pcu.masked_centroid(scene_pts, scene_valid)
        if strategy == "roi_center":
            fallback = pcu.nearest_point(scene_pts, scene_valid, centroid)
        else:
            fallback = centroid
        scene_pt = torch.where(torch.isfinite(scene_pt).all(dim=-1, keepdim=True),
                               scene_pt, fallback)
        if strategy == "roi_center":
            tshift = scene_pt - pcu.nearest_point(model_pts, model_valid, z0)
        else:
            if not params.distance_offset_uses_hole:
                scene_pt = scene_pt + _z_offset(D_aver)
            tshift = scene_pt - z0
    else:
        # Surface-centroid pairing: the model's surface point nearest its
        # centroid lands on the scene's.
        tshift = surface_shift()
    pose0 = geo.make_transform(R_avg, z0 + tshift)
    model_pts_t = model_pts + tshift[:, None, :]
    if ld_valid is not None:
        pose0 = torch.where(ld_valid[:, None, None],
                            ld.pose @ geo.make_transform(R_avg, z0), pose0)
        model_pts_t = torch.where(ld_valid[:, None, None], _apply(ld.pose, model_pts),
                                  model_pts_t)

    # ICP: pose = tf @ pose.  The plane variant converges in < 10
    # iterations on real clusters, and clutter lanes that never converge
    # would spin for the whole budget, so its coarse pass is capped at 40.
    p2plane = scene_n is not None
    if params.icp_variant == "nonlinear" and not p2plane:
        icp_res = icp_nonlinear_schedule(model_pts_t, model_valid, scene_pts, scene_valid)
    else:
        icp_res = _two_stage(
            params, model_pts_t, model_valid, scene_pts, scene_n, scene_valid,
            coarse_iterations=min(params.icp_max_iter, 40) if p2plane else params.icp_max_iter,
            coarse_corr_dist=params.icp_max_corr_dist,
            coarse_rejection=params.icp_ransac_thresh)
    pose = icp_res.transform @ pose0
    model_final = _apply(icp_res.transform, model_pts_t)
    hv_model_valid = model_valid
    fitness = icp_res.fitness

    if p2plane and params.inplane_sweep:
        T_fix, _ = inplane_sweep_fix(model_final, model_valid, scene_pts, scene_n,
                                     scene_valid, active, params.inplane_sweep_deg,
                                     params.inplane_dominance)
        pose = T_fix @ pose
        model_final = _apply(T_fix, model_final)

    # Template-refinement rounds: render the model off-axis at the refined
    # pose (X_cam = Rp X + tp; render computes R (X + T), so T = Rp^T tp)
    # in an r_w x r_h window of the full image centred on the object's
    # projection, re-extract the scene under that render's own mask, and
    # run ICP again.
    for _ in range(params.refine_rounds):
        Rp, tp = pose[:, :3, :3], pose[:, :3, 3]
        zz = tp[:, 2].clamp(min=1e-3)
        u = K_render[0, 0] * tp[:, 0] / zz + K_render[0, 2]
        v = K_render[1, 1] * tp[:, 1] / zz + K_render[1, 2]
        ox = torch.round(u).to(torch.int32) - r_w // 2
        oy = torch.round(v).to(torch.int32) - r_h // 2
        K_vp = K_render.to(torch.float32).expand(L, 3, 3).clone()
        K_vp[:, 0, 2] -= ox.to(torch.float32)
        K_vp[:, 1, 2] -= oy.to(torch.float32)
        out_r = render_fn(triangles, Rp, (Rp.transpose(-1, -2) @ tp[..., None])[..., 0],
                          K_vp, r_w, r_h)
        rpts, rvalid = _model_cloud(out_r, K_vp, active, params)
        spts_r, sval_r, sn_r = _scene_cloud(
            cloud, scene_normals, out_r.mask, out_r.rect, out_r.rect[:, 0] + ox,
            out_r.rect[:, 1] + oy, params)
        # The first-pass scene set where re-extraction found nothing (the
        # pose walked off the frame).
        ok_r = (sval_r.sum(dim=-1) >= 16)[:, None]
        spts_r = torch.where(ok_r[..., None], spts_r, scene_pts)
        sval_r = torch.where(ok_r, sval_r, scene_valid)
        if p2plane:
            sn_r = torch.where(ok_r[..., None], sn_r, scene_n)
        rr = _two_stage(params, rpts, rvalid, spts_r, sn_r, sval_r,
                        coarse_iterations=params.refine_icp_iter,
                        coarse_corr_dist=params.icp_fine_corr_dist * 2.0,
                        coarse_rejection=params.icp_fine_ransac)
        pose = rr.transform @ pose
        fitness = rr.fitness
        model_final = _apply(rr.transform, rpts)
        hv_model_valid = rvalid
        scene_pts, scene_valid, scene_n = spts_r, sval_r, sn_r

    hv_rate = pcu.voxel_occupancy_rate(model_final, hv_model_valid, scene_pts,
                                       scene_valid, params.hv_resolution)
    hv_ok = hv_rate >= params.hv_threshold if params.enable_hv else True
    pose = pose.clone()
    pose[:, :3, :3] = canonicalize(pose[:, :3, :3], params.canonicalize)
    rect = torch.stack([X, Y, out.rect[:, 2], out.rect[:, 3]], dim=-1).to(torch.int32)
    # No inlier at all: the pose is untethered to the scene, and its
    # fitness of 0 would look perfect to a fitness-ranked selection.
    ok = (cluster_valid & hv_ok & (scene_valid.sum(dim=-1) > 10)
          & (model_valid.sum(dim=-1) > 10) & (icp_res.num_inliers > 0))
    return ClusterPose(pose=pose, rect=rect, score=cluster_score, icp_fitness=fitness,
                       hv_rate=hv_rate, valid=ok, rough_pose=pose0, hyp_sim=hyp_sim)


def select_hypothesis(poses: ClusterPose, hyp_cnt: torch.Tensor) -> ClusterPose:
    """Of each cluster's hypotheses ((C, n_hyp, ...) fields), the one with
    the highest mean member similarity + occupancy - 1e4 x ICP residual
    among the non-empty valid ones (the first on ties); slot 0 where none
    is valid (its valid flag records the failure)."""
    key = torch.where((hyp_cnt > 0) & poses.valid,
                      poses.hyp_sim + poses.hv_rate - 1e4 * poses.icp_fitness, -torch.inf)
    b = torch.where(torch.isfinite(key).any(dim=1), key.argmax(dim=1), 0)
    rows = torch.arange(b.shape[0], device=b.device)
    return ClusterPose(*(a[rows, b] for a in poses))


def rough_pose_and_refine(member_quats, member_T, member_D, member_Od, member_x,
                          member_y, member_sims, member_valid, cluster_valid,
                          cluster_score, cloud: torch.Tensor, triangles: torch.Tensor,
                          K_render: torch.Tensor, params: CascadeParams,
                          render_wh: tuple[int, int],
                          scene_normals: torch.Tensor | None = None) -> ClusterPose:
    """Rough pose, position strategy, ICP, refinement rounds, verification
    and canonicalization for C cluster lanes at once (member arrays (C,
    M, ...), cluster arrays (C,), cloud (H, W, 3) in metres), over
    `params.orientation_hypotheses` orientation groups a cluster, of which
    the best-verified is returned.  `scene_normals` (H, W, 3) is needed by
    icp_variant "point_to_plane", which runs "two_stage" without it; an
    unknown icp_variant or position_strategy runs the default one."""
    C = cluster_valid.shape[0]
    n_hyp = params.orientation_hypotheses
    if params.icp_variant != "point_to_plane":
        scene_normals = None
    *hyp, hcnt = _orientation_cluster_average(
        member_quats, member_T, member_D, member_Od, member_x, member_y,
        member_sims, member_valid, params.orientation_clustering_th,
        params.max_seeds, n_hyp=n_hyp)
    per_hyp = lambda a: a.repeat_interleave(n_hyp, dim=0)
    lanes = _pose_lanes(*(a.flatten(0, 1) for a in hyp), hcnt.flatten() > 0,
                        per_hyp(cluster_valid), per_hyp(cluster_score), cloud, triangles,
                        K_render, params, render_wh, scene_normals)
    if n_hyp == 1:
        return lanes
    return select_hypothesis(
        ClusterPose(*(a.reshape(C, n_hyp, *a.shape[1:]) for a in lanes)), hcnt)
