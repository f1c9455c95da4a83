"""Batched template scoring in PyTorch: the back half of the cv::linemod
engine, ported from ``linemod_pose_estimation_tpu/ops/match.py``.

The production path is the pooled exact matcher:

  preprocess_frames_batched  — K1 (ColorGradient quantizer) and K2
      (spread + response maps, 4 calls per batch) on the card, the plain
      versions in ops/features.py on the CPU;
  match_pooled_fine_with_fallback — group-max / cell-max / g x g subcell
      upper bounds over a batch-shared frame-major survivor pool, then the
      exact int8 GEMM over pooled survivors and a per-frame top-k, with the
      exhaustive GEMM as the exact fallback on any pool overflow;
  refine_candidates_opencv_batched — cv::linemod's exact 16 x 16 local
      walk, K3 on the card.

The exhaustive mode (BatchedMatcher(prune=False)) is
coarse_scores_gemm_flat_batched and a per-frame select_candidates_flat,
then the walk.  The per-frame-cap modes are
match_coarse_pruned_fine_with_fallback (`positions`: prune_positions_
batched, fine_ub_at_survivors, fine_plan_from_ub, the survivor GEMM, with
the coarse survivor set and the exhaustive GEMM as exact fallbacks) and
prune_plan_batched with the _sub2 GEMM and select (`two_axis`: both axes
compacted, no fallback).  The window refiners (refine_candidates, _slices, _conv,
_pallas, _pallas_batched) score a dense 24 x 24 window around each
candidate; the last two run K5.  The two-object path
(MultiClassBatchedMatcher) is concat_level_features,
match_coarse_pruned_multiclass or match_pooled_multiclass,
merge_candidates_sorted, the walk and split_matches_by_class.

The single-frame engine (``models/detector.py::Detector.match_raw``) is
preprocess_frame (the B=1 call of the batched preprocess), the
exhaustive GEMM (coarse_scores_gemm), the reference's template-major
select_candidates and refine_candidates_opencv (the B=1 walk);
``Detector.make_matcher_fn`` takes the position-major GEMM and select.

Every output equals the reference's bit for bit.  What changed on the way:

- The int8 GEMMs run on ``torch._int_mm`` (cuBLASLt on the card).  It
  wants k and n multiples of 8, so weights are stored once, K-major and
  zero-padded to n8 (``MatmulWeight``), and outputs are sliced back to n.
- The reference's one-hot gather matmuls and one-hot compaction matmul
  are TPU workarounds; here they are direct index gathers and a
  cumsum + scatter compaction (same frame-major ascending order).
- The reference's ``lax.cond`` fallbacks become host branches on flags
  read with ``.item()``: one device sync per flag, and only the taken
  branch runs, as under ``lax.cond``.
- Top-k keeps the reference's tie order (lower flat index first) by
  selecting on a unique 64-bit key (value bits, then inverted index).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from . import features as F

_NEG = -(2**30)  # margin sentinel below any real margin


class LevelFeatures(NamedTuple):
    """Padded per-level feature set for a bank of N templates.

    offsets: (N, Fmax, 2) int32 — (dy, dx) pixel offsets inside the template
    oris:    (N, Fmax)    int32 — orientation channel (mod*8 + bin merged)
    live:    (N, Fmax)    bool  — which slots hold real features
    count:   (N,)         int32 — total live features (for normalization)
    size:    (N, 2)       int32 — template (h, w) at this level
    """

    offsets: torch.Tensor
    oris: torch.Tensor
    live: torch.Tensor
    count: torch.Tensor
    size: torch.Tensor

    def to(self, device) -> "LevelFeatures":
        return LevelFeatures(*(a.to(device) for a in self))


class CoarseMatches(NamedTuple):
    template_id: torch.Tensor  # (B, K) int32
    cell_y: torch.Tensor  # (B, K) int32 (coarse grid row)
    cell_x: torch.Tensor  # (B, K) int32
    similarity: torch.Tensor  # (B, K) float32 percent
    valid: torch.Tensor  # (B, K) bool


class Matches(NamedTuple):
    """Final refined matches — the analog of cv::linemod::Match records."""

    template_id: torch.Tensor  # (B, K) int32
    x: torch.Tensor  # (B, K) full-res template-origin column
    y: torch.Tensor  # (B, K)
    similarity: torch.Tensor  # (B, K) float32 percent
    valid: torch.Tensor  # (B, K) bool


# ---------------------------------------------------------------------------
# Bank arrays
# ---------------------------------------------------------------------------


def _compact_live_slots(offs, oris, live):
    """Stable live-first permutation of feature slots: live slots occupy
    [0, nf) afterwards (the walk kernel masks by the live array, and this
    keeps live == (f < nf) on every merged bank)."""
    order = torch.argsort((~live).to(torch.uint8), dim=1, stable=True)
    return (
        torch.gather(offs, 1, order[..., None].expand(-1, -1, offs.shape[-1])),
        torch.gather(oris, 1, order),
        torch.gather(live, 1, order),
    )


def merge_modalities(
    feats: Sequence[LevelFeatures], response_maps: Sequence[torch.Tensor]
) -> tuple[LevelFeatures, torch.Tensor]:
    """Concatenate modalities into one feature set + one response stack;
    modality m's orientation indices shift by 8*m."""
    if not len(feats) == len(response_maps) >= 1:
        raise ValueError("need one response stack per modality")
    if len(feats) == 1:
        return feats[0], response_maps[0]
    offs = torch.cat([f.offsets for f in feats], dim=1)
    oris = torch.cat([f.oris + 8 * m for m, f in enumerate(feats)], dim=1)
    live = torch.cat([f.live for f in feats], dim=1)
    offs, oris, live = _compact_live_slots(offs, oris, live)
    count = sum(f.count for f in feats)
    size = torch.stack([f.size for f in feats]).amax(dim=0)
    R = torch.cat(list(response_maps), dim=0)
    return LevelFeatures(offs, oris, live, count, size), R


def _scatter_counts(n_cols: int, row_of, feats: LevelFeatures) -> torch.Tensor:
    """(N, n_cols) int8 counts of live features per (template, bin);
    duplicate bins count with multiplicity."""
    N = feats.oris.shape[0]
    dev = feats.oris.device
    n_idx = torch.arange(N, device=dev)[:, None].expand_as(row_of)
    flat = n_idx * n_cols + row_of.long()
    out = torch.zeros(N * n_cols, dtype=torch.int8, device=dev)
    out.index_put_((flat.reshape(-1),), feats.live.reshape(-1).to(torch.int8),
                   accumulate=True)
    return out.view(N, n_cols)


def build_gemm_weights(feats: LevelFeatures, C: int, T: int, Kc: int) -> torch.Tensor:
    """One-hot GEMM weights (C*T*T*Kc*Kc, N) int8: row index
    ((qy*Kc + qx) * C + ori) * T*T + ry*T + rx for a feature at offset
    (dy, dx) = (qy*T + ry, qx*T + rx).  Built once per bank, template-
    major in memory (a transposed view), the layout int8_mm wants."""
    dy = feats.offsets[..., 0]
    dx = feats.offsets[..., 1]
    qy = (dy // T).clamp(0, Kc - 1)
    qx = (dx // T).clamp(0, Kc - 1)
    row = ((qy * Kc + qx) * C + feats.oris) * (T * T) + (dy % T) * T + (dx % T)
    return _scatter_counts(C * T * T * Kc * Kc, row, feats).t()


def build_cell_weights(feats: LevelFeatures, C: int, T: int, Kc: int) -> torch.Tensor:
    """(N, C*Kc*Kc) int8 feature counts per (cell, orientation) bin — the
    cell-max upper-bound GEMM's weights."""
    qy = (feats.offsets[..., 0] // T).clamp(0, Kc - 1)
    qx = (feats.offsets[..., 1] // T).clamp(0, Kc - 1)
    row = (qy * Kc + qx) * C + feats.oris
    return _scatter_counts(C * Kc * Kc, row, feats)


def build_cell_weights_fine(
    feats: LevelFeatures, C: int, T: int, Kc: int, g: int
) -> torch.Tensor:
    """(N, (Kc*T/g)^2 * C) int8 feature counts per (g x g subcell,
    orientation) bin — the fine upper-bound GEMM's weights."""
    if T % g != 0:
        raise ValueError(f"g={g} must divide T={T}")
    KS = Kc * T // g
    sy = (feats.offsets[..., 0] // g).clamp(0, KS - 1)
    sx = (feats.offsets[..., 1] // g).clamp(0, KS - 1)
    col = (sy * KS + sx) * C + feats.oris
    return _scatter_counts(KS * KS * C, col, feats)


def build_group_bound(
    feats: LevelFeatures, C: int, T: int, Kc: int, group: int,
    W_cell: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Group-max cell-bound weights (Ng, C*Kc*Kc) int8 — the max of W_cell
    over each run of `group` consecutive templates — plus the members'
    feature counts (Ng, group) int32 (0 = dead slot)."""
    Wc_ = build_cell_weights(feats, C, T, Kc) if W_cell is None else W_cell
    N = Wc_.shape[0]
    Ng = -(-N // group)
    pad = Ng * group - N
    Wp = torch.nn.functional.pad(Wc_, (0, 0, 0, pad))
    W_group = Wp.reshape(Ng, group, -1).amax(dim=1)
    counts = torch.nn.functional.pad(feats.count, (0, pad)).reshape(Ng, group)
    return W_group, counts


class MatmulWeight(NamedTuple):
    """A (k, n) int8 GEMM operand, stored K-major as (ceil8(n), k) with
    zero rows padding n (torch._int_mm takes n % 8 == 0), plus the true
    column count n.  K-major is the layout cuBLASLt's int8 tensor-core
    path wants for the second operand ("TN")."""

    nk: torch.Tensor
    n: int

    @staticmethod
    def from_nk(W: torch.Tensor) -> "MatmulWeight":
        n, k = W.shape
        if k % 8:
            raise ValueError(f"contraction size {k} is not a multiple of 8")
        W = torch.nn.functional.pad(W.to(torch.int8), (0, 0, 0, -n % 8))
        return MatmulWeight(W.contiguous(), n)

    @staticmethod
    def from_kn(W: torch.Tensor) -> "MatmulWeight":
        return MatmulWeight.from_nk(W.t())


class BankWeights(NamedTuple):
    """A matcher's bank operands (built once per bank)."""

    W_gemm: MatmulWeight  # exact one-hot weights, (C*T*T*Kc*Kc, N)
    W_cell: MatmulWeight  # cell-max bound, from (N, C*Kc*Kc)
    W_fine: MatmulWeight | None  # g x g subcell bound, from (N, KS*KS*C)
    W_group: MatmulWeight | None  # group-max bound, from (Ng, C*Kc*Kc)
    group_counts: torch.Tensor | None  # (Ng, group) int32


def build_bank_weights(
    feats1: LevelFeatures, C: int, T: int, Kc: int, g: int | None,
    group: int | None = None,
) -> BankWeights:
    """Every bank operand of the pruned matchers, on feats1's device: the
    fine bound's only with `g`, the group tier's only with `group`."""
    W_cell = build_cell_weights(feats1, C, T, Kc)
    W_fine = W_group = counts = None
    if g:
        W_fine = MatmulWeight.from_nk(build_cell_weights_fine(feats1, C, T, Kc, g))
    if group:
        W_group, counts = build_group_bound(feats1, C, T, Kc, group, W_cell=W_cell)
        W_group = MatmulWeight.from_nk(W_group)
    return BankWeights(
        W_gemm=MatmulWeight.from_kn(build_gemm_weights(feats1, C, T, Kc)),
        W_cell=MatmulWeight.from_nk(W_cell), W_fine=W_fine, W_group=W_group,
        group_counts=counts,
    )


def int8_mm(a: torch.Tensor, w: MatmulWeight) -> torch.Tensor:
    """(m, k) int8 x (k, n) int8 -> (m, n) int32, exact.  cuBLASLt's int8
    path takes m > 16, so short operands are zero-padded on the card."""
    m = a.shape[0]
    if a.is_cuda and m <= 16:
        a = torch.nn.functional.pad(a, (0, 0, 0, 17 - m))
    return torch._int_mm(a.contiguous(), w.nk.t())[:m, :w.n]


# ---------------------------------------------------------------------------
# Patch matrices and validity
# ---------------------------------------------------------------------------


def linearize_responses_lanes(R: torch.Tensor, T: int, max_cell_extent: int) -> torch.Tensor:
    """(..., C, H, W) responses -> (..., Hc + Kc, Wc + Kc, C*T*T) planes
    (channel x subcell last), zero-padded by Kc cells bottom/right."""
    *lead, C, H, W = R.shape
    Hc, Wc = H // T, W // T
    Kc = max_cell_extent
    Rc = R[..., : Hc * T, : Wc * T].reshape(*lead, C, Hc, T, Wc, T)
    n = len(lead)
    perm = list(range(n)) + [n + 1, n + 3, n, n + 2, n + 4]
    L = Rc.permute(*perm).reshape(*lead, Hc, Wc, C * T * T)
    return torch.nn.functional.pad(L, (0, 0, 0, Kc, 0, Kc))


def _windows(L: torch.Tensor, Hc: int, Wc: int, Kc: int) -> torch.Tensor:
    """(B, Hc+Kc, Wc+Kc, D) -> (B*Hc*Wc, Kc*Kc*D): row (b, py, px) holds
    L[b, py+qy, px+qx, :] in (qy, qx, lane) order."""
    B, _, _, D = L.shape
    win = L.unfold(1, Kc, 1).unfold(2, Kc, 1)[:, :Hc, :Wc]  # (B,Hc,Wc,D,Kc,Kc)
    return win.permute(0, 1, 2, 4, 5, 3).reshape(B * Hc * Wc, Kc * Kc * D)


def _gemm_patches(Rb: torch.Tensor, T: int, Kc: int) -> torch.Tensor:
    """(B, C, H, W) -> (B*Hc*Wc, C*T*T*Kc*Kc) int8 patch matrix; column
    order matches build_gemm_weights' row index."""
    B, C, H, W = Rb.shape
    L = linearize_responses_lanes(Rb.to(torch.int8), T, Kc)
    return _windows(L, H // T, W // T, Kc)


def _cell_max(Rb: torch.Tensor, T: int, S: int = 1) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, Hc*S, Wc*S) max over (T/S) x (T/S) blocks."""
    B, C, H, W = Rb.shape
    Hc, Wc = H // T, W // T
    s = T // S
    return Rb[:, :, : Hc * T, : Wc * T].reshape(B, C, Hc * S, s, Wc * S, s).amax(dim=(3, 5))


def _ub_patches(Rb: torch.Tensor, T: int, Kc: int) -> torch.Tensor:
    """(B, C, H, W) -> (B*Hc*Wc, Kc*Kc*C) int8 cell-max patch matrix;
    column order matches build_cell_weights' bin index (qy*Kc + qx)*C + c."""
    B, C, H, W = Rb.shape
    Mp = torch.nn.functional.pad(
        _cell_max(Rb, T).permute(0, 2, 3, 1), (0, 0, 0, Kc, 0, Kc)
    ).to(torch.int8)
    return _windows(Mp, H // T, W // T, Kc)


def position_validity(size: torch.Tensor, T: int, Hc: int, Wc: int) -> torch.Tensor:
    """(N, Hc, Wc) bool — window position (i, j) keeps the template in-bounds."""
    dev = size.device
    ii = torch.arange(Hc, dtype=torch.int32, device=dev)[:, None]
    jj = torch.arange(Wc, dtype=torch.int32, device=dev)[None, :]
    h = size[:, 0][:, None, None]
    w = size[:, 1][:, None, None]
    return (ii[None] * T + h <= Hc * T) & (jj[None] * T + w <= Wc * T)


def position_validity_flat(size: torch.Tensor, T: int, Hc: int, Wc: int) -> torch.Tensor:
    """(Hc*Wc, N) bool — position-major twin of position_validity."""
    return position_validity(size, T, Hc, Wc).reshape(size.shape[0], -1).t()


def int_score_threshold(threshold: float, total_features: torch.Tensor) -> torch.Tensor:
    """Per-template integer raw-score threshold t_int (f32) with
    ub >= t_int  <=>  sim_ub >= threshold.  The same f32 expression, in
    the same order, as the reference (whose threshold is a traced f32):
    the slacks can only ADD survivors."""
    thr = torch.tensor(threshold, dtype=torch.float32, device=total_features.device)
    return torch.ceil((thr - 1e-3) * 0.04 * total_features.to(torch.float32) - 1e-4)


# ---------------------------------------------------------------------------
# Candidate selection
# ---------------------------------------------------------------------------


def _sim_scale(total_features: torch.Tensor) -> torch.Tensor:
    """100 / (4 * nf) in f32 as a true division: torch evaluates
    `scalar / tensor` as reciprocal-times-scalar, which is off by an ulp."""
    den = 4.0 * total_features.clamp(min=1).to(torch.float32)
    return torch.full_like(den, 100.0) / den


def _topk_first_index(vals: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim of f32 or int32 `vals`, ties broken by the
    LOWER index first (JAX top_k's order), via one topk on a unique int64
    key: the value (a float's order-preserving int32 image), then the
    inverted index."""
    if vals.dtype == torch.int32:
        key32 = vals.to(torch.int64)
    else:
        bits = vals.contiguous().view(torch.int32)
        key32 = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).to(torch.int64)
    n = vals.shape[-1]
    inv = (0xFFFFFFFF - torch.arange(n, device=vals.device, dtype=torch.int64))
    _, idx = torch.topk(key32 * (1 << 32) + inv, k, dim=-1, largest=True, sorted=True)
    return torch.gather(vals, -1, idx), idx


def _coarse_matches(vals, t, pos, Wc: int, threshold: float) -> CoarseMatches:
    return CoarseMatches(
        t.to(torch.int32),
        torch.div(pos, Wc, rounding_mode="floor").to(torch.int32),
        (pos % Wc).to(torch.int32),
        vals,
        vals >= torch.tensor(threshold, dtype=torch.float32, device=vals.device),
    )


def select_candidates_flat(
    raw_flat: torch.Tensor,
    total_features: torch.Tensor,
    vpos_flat: torch.Tensor,
    threshold: float,
    top_k: int,
    Wc: int,
) -> CoarseMatches:
    """Candidate selection over position-major scores (B, P, N) -> (B, top_k)
    CoarseMatches (the exhaustive path's select)."""
    B, P, N = raw_flat.shape
    scale = _sim_scale(total_features)
    k = min(top_k, P * N)
    out = []
    for b in range(B):  # one frame at a time bounds the (P*N) key memory
        sim = torch.where(vpos_flat, raw_flat[b].to(torch.float32) * scale[None, :],
                          -1.0).reshape(-1)
        vals, idx = _topk_first_index(sim, k)
        out.append(_coarse_matches(vals, idx % N, torch.div(idx, N, rounding_mode="floor"),
                                   Wc, threshold))
    return CoarseMatches(*(torch.stack(a) for a in zip(*out)))


def select_candidates_flat_pos(
    raw_sub: torch.Tensor,
    total_features: torch.Tensor,
    vpos_flat: torch.Tensor,
    p_idx: torch.Tensor,
    p_keep: torch.Tensor,
    threshold: float,
    top_k: int,
    Wc: int,
) -> CoarseMatches:
    """Selection over (B, m, N) survivor-position scores; positions map
    back through p_idx (B, m).  Returns (B, top_k) CoarseMatches."""
    B, m, N = raw_sub.shape
    scale = _sim_scale(total_features)
    vpos_sub = vpos_flat[p_idx] & p_keep[..., None]
    sim = torch.where(vpos_sub, raw_sub.to(torch.float32) * scale, -1.0)
    k = min(top_k, m * N)
    vals, fidx = _topk_first_index(sim.reshape(B, m * N), k)
    pos = torch.gather(p_idx, 1, torch.div(fidx, N, rounding_mode="floor"))
    return _coarse_matches(vals, fidx % N, pos, Wc, threshold)


# ---------------------------------------------------------------------------
# Batch-shared survivor pool (the production pruning path)
# ---------------------------------------------------------------------------


class PoolPlan(NamedTuple):
    """Frame-major survivor pool over a frame batch.

    frame: (M,) int64 — owning frame per pool slot (nondecreasing)
    pos:   (M,) int64 — flat coarse cell within that frame
    keep:  (M,) bool  — slot holds a live survivor
    starts:(B,) int64 — first pool slot of each frame
    m_survivors: (B,) int64 — TRUE per-frame eligible counts (uncapped)
    total: () int64 — true batch-total eligible count
    overflow: () bool — the pool is truncated: callers fall back
    """

    frame: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    starts: torch.Tensor
    m_survivors: torch.Tensor
    total: torch.Tensor
    overflow: torch.Tensor


def _compact_eligible_flat(elig: torch.Tensor, cap: int):
    """Exact, order-preserving compaction of the set entries of `elig`
    (L,) into `cap` slots: (idx (cap,) ascending, keep (cap,), total ()).
    Exclusive-cumsum ranks scatter each set entry's index to its slot
    (ranks past cap land in a discarded slot); dead slots hold idx 0."""
    L = elig.shape[0]
    e = elig.to(torch.int64)
    r = torch.cumsum(e, 0) - e
    total = e.sum()
    tgt = torch.where(elig & (r < cap), r, cap)
    idx = torch.zeros(cap + 1, dtype=torch.int64, device=elig.device)
    idx.scatter_(0, tgt, torch.arange(L, device=elig.device))
    idx = idx[:cap]
    slot = torch.arange(cap, device=elig.device)
    keep = slot < torch.clamp(total, max=cap)
    return idx, keep, total


def _per_frame_counts(frame: torch.Tensor, mask: torch.Tensor, B: int) -> torch.Tensor:
    return torch.zeros(B, dtype=torch.int64, device=frame.device).index_add_(
        0, frame, mask.to(torch.int64))


def pool_plan_from_margins(margins: torch.Tensor, cap: int) -> PoolPlan:
    """(B, P) position margins -> the frame-major PoolPlan of every
    eligible (margin >= 0) position."""
    B, P = margins.shape
    elig2 = margins >= 0
    idx, keep, total = _compact_eligible_flat(elig2.reshape(-1), cap)
    m_surv = elig2.sum(dim=1)
    starts = torch.cumsum(m_surv, 0) - m_surv
    return PoolPlan(
        frame=torch.div(idx, P, rounding_mode="floor"), pos=idx % P, keep=keep,
        starts=starts, m_survivors=m_surv, total=total, overflow=total > cap,
    )


def position_margins_batched(
    Rb: torch.Tensor,
    W_cell: MatmulWeight,
    total_features: torch.Tensor,
    vpos_flat: torch.Tensor,
    threshold: float,
    T: int,
    Kc: int,
) -> torch.Tensor:
    """(B, P) int32 margins max_n(ub(p, n) - t_int[n]) over the cell-max
    bound, invalid positions at a deep sentinel.  int32 throughout (the
    reference's int16 branch is a TPU bandwidth trick; both give the same
    margin wherever it is >= 0, the only test any caller makes)."""
    B, C, H, W = Rb.shape
    P = (H // T) * (W // T)
    ub = int8_mm(_ub_patches(Rb, T, Kc), W_cell).reshape(B, P, -1)
    t_int = int_score_threshold(threshold, total_features).to(torch.int32)
    margin = torch.where(vpos_flat[None], ub - t_int, torch.iinfo(torch.int32).min)
    return margin.amax(dim=2)


def gather_windows_pooled(
    L3: torch.Tensor, row0: torch.Tensor, col0: torch.Tensor, K: int
) -> torch.Tensor:
    """out[m, qy, qx, :] = L3[row0[m]+qy, col0[m]+qx, :] as a direct index
    gather over frame-stacked planes L3 (G, Wx, Ct): (M, K*K*Ct) in the
    (qy*K + qx)*Ct + lane order of _gemm_patches."""
    q = torch.arange(K, device=L3.device)
    rows = row0[:, None] + q
    cols = col0[:, None] + q
    out = L3[rows[:, :, None], cols[:, None, :]]  # (M, K, K, Ct)
    return out.reshape(row0.shape[0], -1)


def pool_plan_grouped(
    Rb: torch.Tensor,
    W_cell: MatmulWeight,
    W_group: MatmulWeight,
    group_counts: torch.Tensor,
    total_features: torch.Tensor,
    vpos_flat: torch.Tensor,
    threshold: float,
    T: int,
    Kc: int,
    pool0: int,
    pool1: int,
    group: int,
) -> PoolPlan:
    """Two-tier pooled planning: the group-max pre-bound over every
    position -> a loose frame-major pool (pool0), then the per-template
    cell bound at those pooled positions only -> the exact eligible set
    position_margins_batched would give (pool1)."""
    B, C, H, W = Rb.shape
    Hc, Wc_ = H // T, W // T
    P = Hc * Wc_
    N = total_features.shape[0]
    Ng = group_counts.shape[0]

    # Tier 0: group bound at every position.
    ubg = int8_mm(_ub_patches(Rb, T, Kc), W_group)  # (B*P, Ng)
    t_int = int_score_threshold(threshold, total_features).to(torch.int32)
    t_pad = torch.nn.functional.pad(t_int, (0, Ng * group - N)).reshape(Ng, group)
    t_g = torch.where(group_counts > 0, t_pad, 2**30).amin(dim=1)
    vpad = torch.nn.functional.pad(vpos_flat, (0, Ng * group - N))
    vpos_g = vpad.reshape(P, Ng, group).any(dim=2)  # (P, Ng)
    margin_g = torch.where(vpos_g.repeat(B, 1), ubg - t_g[None, :], _NEG)
    pp0 = pool_plan_from_margins(margin_g.amax(dim=1).reshape(B, P), pool0)

    # Tier 1: per-template cell bound at the pooled positions only.
    Mp = torch.nn.functional.pad(
        _cell_max(Rb, T).permute(0, 2, 3, 1), (0, 0, 0, Kc, 0, Kc)
    ).to(torch.int8)  # (B, Hc+Kc, Wc+Kc, C)
    Hy = Hc + Kc
    L3 = Mp.reshape(B * Hy, Wc_ + Kc, C)
    Pub = gather_windows_pooled(
        L3, pp0.frame * Hy + torch.div(pp0.pos, Wc_, rounding_mode="floor"),
        pp0.pos % Wc_, Kc,
    )
    ub = int8_mm(Pub, W_cell)  # (M0, N)
    margin = torch.where(vpos_flat[pp0.pos] & pp0.keep[:, None],
                         ub - t_int[None, :], _NEG)
    elig = margin.amax(dim=1) >= 0
    idx, keep, total = _compact_eligible_flat(elig, pool1)
    m_surv = _per_frame_counts(pp0.frame, elig, B)
    return PoolPlan(
        frame=pp0.frame[idx], pos=pp0.pos[idx], keep=keep,
        starts=torch.cumsum(m_surv, 0) - m_surv, m_survivors=m_surv,
        total=total, overflow=pp0.overflow | (total > pool1),
    )


def fine_ub_at_pool(
    Rb: torch.Tensor,
    frame: torch.Tensor,
    pos: torch.Tensor,
    W_fine: MatmulWeight,
    T: int,
    Kc: int,
    g: int,
) -> torch.Tensor:
    """g x g subcell upper bound at pool candidates: (M, N) int32."""
    B, C, H, W = Rb.shape
    Wc_ = W // T
    S = T // g
    KS = Kc * S
    Rm = _cell_max(Rb, T, S)  # (B, C, Hs, Ws)
    Hs, Ws = Rm.shape[2:]
    Pp = torch.nn.functional.pad(
        Rm.permute(0, 2, 3, 1), (0, 0, 0, KS, 0, KS)
    ).to(torch.int8)  # (B, Hs+KS, Ws+KS, C)
    Hy = Hs + KS
    L3 = Pp.reshape(B * Hy, Ws + KS, C)
    row0 = frame * Hy + torch.div(pos, Wc_, rounding_mode="floor") * S
    col0 = (pos % Wc_) * S
    return int8_mm(gather_windows_pooled(L3, row0, col0, KS), W_fine)


def _survivor_patches(Rb: torch.Tensor, frame: torch.Tensor, pos: torch.Tensor,
                      T: int, Kc: int) -> torch.Tensor:
    """(M, Kc*Kc*C*T*T) int8 exact-GEMM patch rows of the survivors
    (frame[m], flat cell pos[m]): each row's Kc x Kc cell vectors gathered
    straight from the linearized-cell tensor, in _gemm_patches' column
    order."""
    B, C, H, W = Rb.shape
    Hc, Wc_ = H // T, W // T
    L = linearize_responses_lanes(Rb.to(torch.int8), T, Kc)
    Hy = Hc + Kc
    L3 = L.reshape(B * Hy, Wc_ + Kc, C * T * T)
    row0 = frame * Hy + torch.div(pos, Wc_, rounding_mode="floor")
    return gather_windows_pooled(L3, row0, pos % Wc_, Kc)


def coarse_scores_gemm_pooled(
    Rb: torch.Tensor,
    W_gemm: MatmulWeight,
    frame: torch.Tensor,
    pos: torch.Tensor,
    T: int,
    Kc: int,
) -> torch.Tensor:
    """Exact coarse GEMM over pool candidates: (M, N) int32 — rows of the
    exhaustive GEMM, bit for bit."""
    return int8_mm(_survivor_patches(Rb, frame, pos, T, Kc), W_gemm)


def coarse_scores_gemm_flat_batched(
    Rb: torch.Tensor, W_gemm: MatmulWeight, T: int, Kc: int
) -> torch.Tensor:
    """(B, C, H, W) -> (B, Hc*Wc, N) int32 via ONE GEMM (the exhaustive
    scorer the pooled path falls back to)."""
    B, C, H, W = Rb.shape
    P = (H // T) * (W // T)
    return int8_mm(_gemm_patches(Rb, T, Kc), W_gemm).reshape(B, P, -1)


def select_candidates_pooled(
    raw: torch.Tensor,
    total_features: torch.Tensor,
    vpos_flat: torch.Tensor,
    frame: torch.Tensor,
    pos: torch.Tensor,
    keep: torch.Tensor,
    starts: torch.Tensor,
    m_survivors: torch.Tensor,
    threshold: float,
    top_k: int,
    Wc: int,
    r_cap: int,
):
    """Per-frame selection from pooled scores (M, N): frame b selects over
    the r_cap rows from clip(starts[b], 0, M - r_cap), masked to its own
    rows — the reference's dynamic slice, so even the sub-threshold filler
    slots agree.  Returns (CoarseMatches (B, top_k), n_valid (B,),
    sel_overflow ())."""
    M_, N = raw.shape
    B = starts.shape[0]
    rc = min(r_cap, M_)
    sel_overflow = (m_survivors > rc).any()
    s = starts.clamp(0, M_ - rc)
    rows = s[:, None] + torch.arange(rc, device=raw.device)  # (B, rc)
    own = keep[rows] & (frame[rows] == torch.arange(B, device=raw.device)[:, None])
    cands = select_candidates_flat_pos(
        raw[rows], total_features, vpos_flat, pos[rows], own, threshold, top_k, Wc
    )
    n_valid = cands.valid.sum(dim=1).to(torch.int32)
    return cands, n_valid, sel_overflow


class PooledStats(NamedTuple):
    """Capacity telemetry of one pooled match step.

    coarse_total/fine_total: () — TRUE batch-total survivors
    coarse_m/fine_m: (B,) — TRUE per-frame survivor counts
    coarse_overflow/fine_overflow/sel_overflow: () bool — per-stage pool
        or select-cap misses (each alone forces a fallback)
    fallback: () bool — the batch took the exhaustive branch
    """

    coarse_total: torch.Tensor
    coarse_m: torch.Tensor
    coarse_overflow: torch.Tensor
    fine_total: torch.Tensor
    fine_m: torch.Tensor
    fine_overflow: torch.Tensor
    sel_overflow: torch.Tensor
    fallback: torch.Tensor


def match_pooled_fine_with_fallback(
    Rb: torch.Tensor,
    W_gemm: MatmulWeight,
    W_cell: MatmulWeight,
    W_fine: MatmulWeight,
    total_features: torch.Tensor,
    vpos_flat: torch.Tensor,
    threshold: float,
    T: int,
    Kc: int,
    g: int,
    pool1: int,
    pool2: int,
    top_k: int,
    Wc: int,
    r_cap: int = 128,
    W_group: MatmulWeight | None = None,
    group_counts: torch.Tensor | None = None,
    pool0: int | None = None,
    group: int | None = None,
) -> tuple[CoarseMatches, torch.Tensor, PooledStats]:
    """Two-stage exact pruning over a batch-shared survivor pool.

    Stage 1: cell-max bound (with `W_group` set: the group-max pre-bound
    first, pool_plan_grouped) -> frame-major pool of every eligible
    position (pool1).  Stage 2: g x g subcell bound at pool candidates ->
    compacted fine pool (pool2).  Exact pass: pooled survivor patches x
    the static (K, N) weights, then per-frame select over contiguous pool
    ranges.  Any pool or select-range overflow routes the batch through
    the exhaustive GEMM, so the candidate set is unconditionally exact.

    The reference's three lax.cond's are host branches here: each reads
    its flag with .item() (one device sync) and runs only the taken
    branch.  Returns (CoarseMatches (B, top_k), n_valid (B,), PooledStats).
    """
    if T % g != 0:
        raise ValueError(f"g={g} must divide T={T}")
    B = Rb.shape[0]
    dev = Rb.device
    if W_group is not None:
        pp = pool_plan_grouped(
            Rb, W_cell, W_group, group_counts, total_features, vpos_flat,
            threshold, T, Kc, pool0, pool1, group,
        )
    else:
        margins = position_margins_batched(
            Rb, W_cell, total_features, vpos_flat, threshold, T, Kc
        )
        pp = pool_plan_from_margins(margins, pool1)
    t_int = int_score_threshold(threshold, total_features).to(torch.int32)
    cands, n_valid, stats = _pooled_selects(
        Rb, pp, t_int, W_gemm, W_fine, total_features, vpos_flat,
        [(vpos_flat, threshold)], T, Kc, g, pool1, pool2, top_k, Wc, r_cap)
    return cands[0], n_valid[0], stats


def _pooled_selects(
    Rb, pp: PoolPlan, t_int, W_gemm, W_fine, total_features, vpos_flat,
    classes, T, Kc, g, pool1, pool2, top_k, Wc, r_cap,
) -> tuple[list[CoarseMatches], list[torch.Tensor], PooledStats]:
    """The pooled matcher after its coarse plan `pp`: the g x g fine
    re-test at the pool (pool2; on overflow the coarse pool is scored
    instead), the exact pooled GEMM and one select per class, and the
    exhaustive GEMM when the coarse pool or a select range overflows.
    `classes` holds (vpos_c (P, N), threshold_c) per class: each class
    selects over its own columns at its own threshold.  Returns per-class
    lists of CoarseMatches (B, top_k) and n_valid (B,), and PooledStats."""
    B = Rb.shape[0]
    dev = Rb.device
    P2 = min(pool2, pool1)
    false = torch.zeros((), dtype=torch.bool, device=dev)

    if pp.overflow.item():
        # Coarse pool overflowed: the fine stage and the selects never run.
        z = torch.zeros((B, top_k), dtype=torch.int32, device=dev)
        empty = CoarseMatches(z, z, z, torch.full((B, top_k), -1.0, device=dev),
                              torch.zeros((B, top_k), dtype=torch.bool, device=dev))
        cands = [empty] * len(classes)
        n_valid = [torch.zeros(B, dtype=torch.int32, device=dev)] * len(classes)
        sel_of, of2 = false, false
        fine_total = torch.zeros((), dtype=torch.int64, device=dev)
        fine_m = torch.zeros(B, dtype=torch.int64, device=dev)
    else:
        ubf = fine_ub_at_pool(Rb, pp.frame, pp.pos, W_fine, T, Kc, g)
        fmargin = torch.where(vpos_flat[pp.pos] & pp.keep[:, None],
                              ubf - t_int[None, :], _NEG)
        felig = fmargin.amax(dim=1) >= 0
        fine_m = _per_frame_counts(pp.frame, felig, B)
        idx2, keep2, fine_total = _compact_eligible_flat(felig, P2)
        of2 = fine_total > P2
        if of2.item():
            frame, pos, keep = pp.frame, pp.pos, pp.keep
            starts, m_surv = pp.starts, pp.m_survivors
        else:
            frame, pos, keep = pp.frame[idx2], pp.pos[idx2], keep2
            starts, m_surv = torch.cumsum(fine_m, 0) - fine_m, fine_m
        raw = coarse_scores_gemm_pooled(Rb, W_gemm, frame, pos, T, Kc)
        cands, n_valid, sel_of = [], [], false
        for vpos_c, thr_c in classes:
            c, nv, so = select_candidates_pooled(
                raw, total_features, vpos_c, frame, pos, keep, starts, m_surv,
                thr_c, top_k, Wc, r_cap,
            )
            cands.append(c)
            n_valid.append(nv)
            sel_of = sel_of | so
    fallback = pp.overflow | sel_of
    if fallback.item():
        raw = coarse_scores_gemm_flat_batched(Rb, W_gemm, T, Kc)
        cands = [select_candidates_flat(raw, total_features, vpos_c, thr_c, top_k, Wc)
                 for vpos_c, thr_c in classes]
        n_valid = [c.valid.sum(dim=1).to(torch.int32) for c in cands]
    stats = PooledStats(
        coarse_total=pp.total, coarse_m=pp.m_survivors,
        coarse_overflow=pp.overflow, fine_total=fine_total, fine_m=fine_m,
        fine_overflow=of2, sel_overflow=sel_of, fallback=fallback,
    )
    return cands, n_valid, stats


# ---------------------------------------------------------------------------
# Per-frame survivor caps: the `positions` and `two_axis` prune modes
# ---------------------------------------------------------------------------
#
# The cell-max bound again, compacted per frame instead of into one pool:
# every frame keeps its m_cap highest-margin survivor positions, so every
# stage is sized by B * m_cap whatever the scene holds.  In `positions`
# mode any frame past a cap sends the whole batch down a fallback (the
# fine stage's: the coarse survivor set; the coarse stage's: the
# exhaustive GEMM), so the candidate set stays exact.  `two_axis` also
# compacts the batch-union template axis and has no fallback: over
# capacity it keeps the highest-bound entries and reports the flag.
#
# The reference assembles survivor patches with two one-hot matmuls (a TPU
# workaround, kept here as gather_cell_patches_onehot for the tests); the
# port gathers them directly, as the pooled path does.


class PruneResult(NamedTuple):
    """Survivor-template compaction of a bank for one frame batch.

    idx:  (n_cap,) int32 — global template ids of the survivors (the
          n_cap highest-bound ones when over capacity)
    keep: (n_cap,) bool — slot holds a real survivor
    n_survivors: () int32 — true survivor count (before capping)
    overflow: () bool — n_survivors > n_cap: exactness no longer holds
          for the templates left out
    """

    idx: torch.Tensor
    keep: torch.Tensor
    n_survivors: torch.Tensor
    overflow: torch.Tensor


class PrunePlan(NamedTuple):
    """Per-frame survivor compaction on the position axis, and (in
    `two_axis` mode) a batch-union one on the template axis; in
    `positions` mode the template axis is the identity.

    t_idx/t_keep: (n_cap,) int32 / bool — survivor templates (global ids)
    p_idx/p_keep: (B, m_cap) int32 / bool — survivor flat positions
    n_survivors: () int32 — true template-survivor count
    m_survivors: (B,) int32 — true position-survivor count per frame
    overflow: () bool — either axis over capacity
    """

    t_idx: torch.Tensor
    t_keep: torch.Tensor
    p_idx: torch.Tensor
    p_keep: torch.Tensor
    n_survivors: torch.Tensor
    m_survivors: torch.Tensor
    overflow: torch.Tensor


class FinePlan(NamedTuple):
    """Second-stage (g x g subcell bound) survivor-position compaction.

    p_idx: (B, m2_cap) int32 — fine-surviving flat positions (compacted
           from the coarse PrunePlan's p_idx)
    p_keep: (B, m2_cap) bool — slot holds a live position
    m_survivors: (B,) int32 — true fine-survivor count per frame
    overflow: () bool — a frame exceeded m2_cap: callers score the coarse
           survivor set instead
    """

    p_idx: torch.Tensor
    p_keep: torch.Tensor
    m_survivors: torch.Tensor
    overflow: torch.Tensor


def _default_cap(cap: int | None, parent_cap: int, name: str) -> int:
    """None -> half the parent cap; an explicit non-positive value is an
    error (an explicit 0 must not silently become the default)."""
    if cap is None:
        return max(parent_cap // 2, 1)
    if cap <= 0:
        raise ValueError(f"{name} must be positive (got {cap}); pass None "
                         "for the default")
    return cap


def _count_i32(mask: torch.Tensor, dim=None) -> torch.Tensor:
    return (mask.sum() if dim is None else mask.sum(dim=dim)).to(torch.int32)


def _sim_upper_bound(Rb, W_cell: MatmulWeight, total_features, vpos_flat, T, Kc):
    """(B, P, N) f32 similarity of the cell-max bound, invalid positions
    -1: one f32 multiply by the per-template scale, as the reference."""
    B, C, H, W = Rb.shape
    P = (H // T) * (W // T)
    ub = int8_mm(_ub_patches(Rb, T, Kc), W_cell).reshape(B, P, -1)
    sim_ub = ub.to(torch.float32) * _sim_scale(total_features)
    return torch.where(vpos_flat[None], sim_ub, -1.0)


def _float_slack_threshold(threshold: float, device) -> torch.Tensor:
    """threshold - 1e-3 in f32: the two_axis planners' float eligibility
    rule (the slack can only ADD survivors)."""
    return (torch.tensor(threshold, dtype=torch.float32, device=device)
            - torch.tensor(1e-3, dtype=torch.float32, device=device))


def _top_eligible(score: torch.Tensor, elig: torch.Tensor, k: int):
    """The k highest-scoring eligible entries along the last dim (ties:
    the lower index), ineligible ones at -inf: (idx int32, keep)."""
    vals, idx = _topk_first_index(
        torch.where(elig, score, float("-inf")), k)
    return idx.to(torch.int32), vals > float("-inf")


def prune_templates_batched(
    Rb: torch.Tensor,
    W_cell: MatmulWeight,
    total_features: torch.Tensor,
    vpos_flat: torch.Tensor,
    threshold: float,
    T: int,
    Kc: int,
    n_cap: int,
) -> PruneResult:
    """Upper-bound pass over a (B, C, H, W) response batch: the compacted
    set of templates whose bound similarity reaches `threshold` at any
    valid position of any frame (a superset of every template that can
    appear as a candidate at that threshold)."""
    sim_ub = _sim_upper_bound(Rb, W_cell, total_features, vpos_flat, T, Kc)
    t_score = sim_ub.amax(dim=(0, 1))
    elig = t_score >= _float_slack_threshold(threshold, Rb.device)
    n_surv = _count_i32(elig)
    k = min(n_cap, W_cell.n)
    idx, keep = _top_eligible(t_score, elig, k)
    return PruneResult(idx, keep, n_surv, n_surv > k)


def prune_plan_batched(
    Rb: torch.Tensor,
    W_cell: MatmulWeight,
    total_features: torch.Tensor,
    vpos_flat: torch.Tensor,
    threshold: float,
    T: int,
    Kc: int,
    n_cap: int,
    m_cap: int,
) -> PrunePlan:
    """One cell-max bound GEMM -> survivor compaction on BOTH axes (the
    `two_axis` mode's plan)."""
    sim_ub = _sim_upper_bound(Rb, W_cell, total_features, vpos_flat, T, Kc)
    thr = _float_slack_threshold(threshold, Rb.device)
    t_score = sim_ub.amax(dim=(0, 1))  # (N,)
    t_elig = t_score >= thr
    n_surv = _count_i32(t_elig)
    kn = min(n_cap, W_cell.n)
    t_idx, t_keep = _top_eligible(t_score, t_elig, kn)
    p_score = sim_ub.amax(dim=2)  # (B, P)
    p_elig = p_score >= thr
    m_surv = _count_i32(p_elig, 1)
    km = min(m_cap, p_score.shape[1])
    p_idx, p_keep = _top_eligible(p_score, p_elig, km)
    overflow = (n_surv > kn) | (m_surv > km).any()
    return PrunePlan(t_idx, t_keep, p_idx, p_keep, n_surv, m_surv, overflow)


def prune_positions_batched(
    Rb: torch.Tensor,
    W_cell: MatmulWeight,
    total_features: torch.Tensor,
    vpos_flat: torch.Tensor,
    threshold: float,
    T: int,
    Kc: int,
    m_cap: int,
) -> PrunePlan:
    """Position-axis-only pruning: the int-domain cell-max margins
    (position_margins_batched) -> each frame's m_cap highest-margin
    eligible positions, ties to the lower cell.  The template axis of the
    plan is the identity, so the exact GEMM keeps the static weights.
    Every (position, template) whose exact score reaches threshold
    survives: the bound dominates the exact response at every feature."""
    N = W_cell.n
    dev = Rb.device
    p_score = position_margins_batched(
        Rb, W_cell, total_features, vpos_flat, threshold, T, Kc)
    p_elig = p_score >= 0
    m_surv = _count_i32(p_elig, 1)
    km = min(m_cap, p_score.shape[1])
    pv, p_idx = _topk_first_index(torch.where(p_elig, p_score, _NEG), km)
    return PrunePlan(
        torch.arange(N, dtype=torch.int32, device=dev),
        torch.ones(N, dtype=torch.bool, device=dev),
        p_idx.to(torch.int32), pv > _NEG,
        torch.tensor(N, dtype=torch.int32, device=dev), m_surv,
        (m_surv > km).any(),
    )


def _frame_pos(p_idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, m) per-frame positions -> flat (frame, pos) int64 pairs."""
    B, m = p_idx.shape
    frame = torch.arange(B, device=p_idx.device).repeat_interleave(m)
    return frame, p_idx.reshape(-1).long()


def gather_cell_patches_onehot(L4: torch.Tensor, p_idx: torch.Tensor, Kc: int,
                               Wc: int) -> torch.Tensor:
    """The reference's survivor patch gather as two one-hot contractions
    (columns, then rows): (B, Hy, Wx, D) int8 planes and (B, m) flat cells
    -> (B, m, Kc*Kc*D) int8.  Kept as the plain version the direct gather
    (assemble_survivor_patches) is tested against; nothing else calls it."""
    B, Hy, Wx, D = L4.shape
    dev = L4.device
    py = torch.div(p_idx, Wc, rounding_mode="floor").long()
    px = (p_idx % Wc).long()
    q = torch.arange(Kc, device=dev)
    Csel = (torch.arange(Wx, device=dev)[None, None, :, None]
            == (px[..., None, None] + q)).to(torch.int32)  # (B, m, Wx, Kc)
    Rsel = (torch.arange(Hy, device=dev)[None, None, :, None]
            == (py[..., None, None] + q)).to(torch.int32)  # (B, m, Hy, Kc)
    s1 = torch.einsum("byxt,bjxr->bjyrt", L4.to(torch.int32), Csel)
    s2 = torch.einsum("bjyrt,bjyq->bjqrt", s1, Rsel)
    return s2.to(torch.int8).reshape(B, p_idx.shape[1], Kc * Kc * D)


def assemble_survivor_patches(Rb: torch.Tensor, p_idx: torch.Tensor, T: int,
                              Kc: int) -> torch.Tensor:
    """(B, C, H, W) responses + (B, m) survivor cells -> (B, m, K) int8
    patch rows of the exact survivor GEMM (build_gemm_weights' column
    order), gathered directly from the linearized-cell tensor."""
    B, m = p_idx.shape
    return _survivor_patches(Rb, *_frame_pos(p_idx), T, Kc).reshape(B, m, -1)


def coarse_scores_gemm_flat_batched_pos(
    Rb: torch.Tensor, W_gemm: MatmulWeight, p_idx: torch.Tensor, T: int, Kc: int
) -> torch.Tensor:
    """Exact coarse GEMM over per-frame survivor POSITIONS with the full
    static weights: (B, m_cap, N) int32 — rows of the exhaustive GEMM."""
    B, m = p_idx.shape
    return coarse_scores_gemm_pooled(
        Rb, W_gemm, *_frame_pos(p_idx), T, Kc).reshape(B, m, -1)


def fine_ub_at_survivors(
    Rb: torch.Tensor, p_idx: torch.Tensor, W_fine: MatmulWeight, T: int, Kc: int,
    g: int,
) -> torch.Tensor:
    """g x g subcell upper bound at per-frame survivors: (B, m, N) int32.
    It dominates the exact raw score and is dominated by the cell-max
    bound."""
    B, m = p_idx.shape
    return fine_ub_at_pool(Rb, *_frame_pos(p_idx), W_fine, T, Kc, g).reshape(B, m, -1)


def fine_plan_from_ub(
    ub_fine: torch.Tensor,
    total_features: torch.Tensor,
    vpos_flat: torch.Tensor,
    p_idx: torch.Tensor,
    p_keep: torch.Tensor,
    threshold: float,
    m2_cap: int,
) -> FinePlan:
    """Coarse survivors -> fine survivors: a position stays only if SOME
    template's fine bound still reaches threshold there (the same int
    rule as prune_positions_batched), re-ranked by fine margin and
    compacted to m2_cap slots."""
    m = ub_fine.shape[1]
    t_int = int_score_threshold(threshold, total_features).to(torch.int32)
    margin = torch.where(vpos_flat[p_idx.long()], ub_fine - t_int, _NEG)
    p_score = margin.amax(dim=2)  # (B, m)
    keep2 = (p_score >= 0) & p_keep
    m_surv = _count_i32(keep2, 1)
    km = min(m2_cap, m)
    pv, j2 = _topk_first_index(torch.where(keep2, p_score, _NEG), km)
    return FinePlan(torch.gather(p_idx, 1, j2), pv > _NEG, m_surv,
                    (m_surv > km).any())


def _positions_selects(
    Rb, pp: PrunePlan, W_gemm, W_fine, total_features, vpos_flat, classes,
    thr_bound: float, T, Kc, g, m2_cap, top_k, Wc,
) -> tuple[list[CoarseMatches], FinePlan | None]:
    """The `positions` matcher after its coarse plan `pp`: with a fine
    stage (`g`), the subcell re-test at `thr_bound` and the exact GEMM
    over the fine survivors, or over the coarse ones when a frame
    overflows m2_cap; the exhaustive GEMM when `pp` overflowed.  One
    select per (vpos_c, threshold_c) of `classes`.  The reference's nested
    lax.cond's are host branches here: each reads its flag with .item()
    (one device sync) and only the taken branch runs.  Returns the
    per-class CoarseMatches (B, top_k) and the FinePlan (None without a
    fine stage; a placeholder holding nothing on the exhaustive branch)."""
    B = Rb.shape[0]
    dev = Rb.device

    def select_at(p_idx, p_keep):
        raw = coarse_scores_gemm_flat_batched_pos(Rb, W_gemm, p_idx, T, Kc)
        return [select_candidates_flat_pos(raw, total_features, vpos_c, p_idx.long(),
                                           p_keep, thr_c, top_k, Wc)
                for vpos_c, thr_c in classes]

    if pp.overflow.item():
        raw = coarse_scores_gemm_flat_batched(Rb, W_gemm, T, Kc)
        cands = [select_candidates_flat(raw, total_features, vpos_c, thr_c, top_k, Wc)
                 for vpos_c, thr_c in classes]
        if g is None:
            return cands, None
        km2 = min(m2_cap, pp.p_idx.shape[1])
        return cands, FinePlan(
            pp.p_idx[:, :km2], torch.zeros((B, km2), dtype=torch.bool, device=dev),
            torch.zeros(B, dtype=torch.int32, device=dev),
            torch.zeros((), dtype=torch.bool, device=dev))
    if g is None:
        return select_at(pp.p_idx, pp.p_keep), None
    ubf = fine_ub_at_survivors(Rb, pp.p_idx, W_fine, T, Kc, g)
    fp = fine_plan_from_ub(ubf, total_features, vpos_flat, pp.p_idx, pp.p_keep,
                           thr_bound, m2_cap)
    del ubf
    if fp.overflow.item():
        return select_at(pp.p_idx, pp.p_keep), fp
    return select_at(fp.p_idx, fp.p_keep), fp


def match_coarse_pruned_fine_with_fallback(
    Rb: torch.Tensor,
    W_gemm: MatmulWeight,
    W_cell: MatmulWeight,
    W_fine: MatmulWeight,
    total_features: torch.Tensor,
    vpos_flat: torch.Tensor,
    threshold: float,
    T: int,
    Kc: int,
    g: int,
    m_cap: int,
    m2_cap: int,
    top_k: int,
    Wc: int,
) -> tuple[CoarseMatches, PrunePlan, FinePlan]:
    """Two-stage exact position pruning with per-frame caps.

    Stage 1 (prune_positions_batched): the cell-max bound over every
    coarse position -> m_cap survivor positions per frame.  Stage 2
    (fine_ub_at_survivors + fine_plan_from_ub): the g x g subcell bound at
    the survivors, compacted to m2_cap.  Exact pass: survivor patches x
    the exhaustive engine's static weights.  A fine overflow scores all
    m_cap coarse survivors, a coarse overflow every position, so the
    candidate set is unconditionally exact.  Returns (CoarseMatches (B,
    top_k), PrunePlan, FinePlan)."""
    if T % g != 0:
        raise ValueError(f"g={g} must divide T={T}")
    pp = prune_positions_batched(
        Rb, W_cell, total_features, vpos_flat, threshold, T, Kc, m_cap)
    cands, fp = _positions_selects(
        Rb, pp, W_gemm, W_fine, total_features, vpos_flat,
        [(vpos_flat, threshold)], threshold, T, Kc, g, m2_cap, top_k, Wc)
    return cands[0], pp, fp


def match_coarse_pruned_with_fallback(
    Rb: torch.Tensor,
    W_gemm: MatmulWeight,
    W_cell: MatmulWeight,
    total_features: torch.Tensor,
    vpos_flat: torch.Tensor,
    threshold: float,
    T: int,
    Kc: int,
    m_cap: int,
    top_k: int,
    Wc: int,
) -> tuple[CoarseMatches, PrunePlan]:
    """Position-pruned coarse pass without the fine stage: the exact GEMM
    over each frame's m_cap survivors, or over every position when any
    frame overflows m_cap.  Returns (CoarseMatches (B, top_k), PrunePlan)."""
    pp = prune_positions_batched(
        Rb, W_cell, total_features, vpos_flat, threshold, T, Kc, m_cap)
    cands, _ = _positions_selects(
        Rb, pp, W_gemm, None, total_features, vpos_flat,
        [(vpos_flat, threshold)], threshold, T, Kc, None, None, top_k, Wc)
    return cands[0], pp


def _gathered_weight(W_gemm: MatmulWeight, idx: torch.Tensor) -> MatmulWeight:
    """The exact GEMM's weights of the templates `idx` only: rows of the
    K-major operand (a contiguous row gather), padded to 8 again."""
    return MatmulWeight.from_nk(W_gemm.nk[idx.long()])


def coarse_scores_gemm_flat_batched_sub2(
    Rb: torch.Tensor, W_gemm: MatmulWeight, t_idx: torch.Tensor,
    p_idx: torch.Tensor, T: int, Kc: int,
) -> torch.Tensor:
    """Exact coarse GEMM over the survivor grid only: (B, m_cap, n_cap)
    int32 (dead slots hold real scores of whatever they index; the select
    masks them)."""
    return coarse_scores_gemm_flat_batched_pos(
        Rb, _gathered_weight(W_gemm, t_idx), p_idx, T, Kc)


def select_candidates_flat_sub2(
    raw_sub: torch.Tensor,
    total_features: torch.Tensor,
    vpos_flat: torch.Tensor,
    t_idx: torch.Tensor,
    t_keep: torch.Tensor,
    p_idx: torch.Tensor,
    p_keep: torch.Tensor,
    threshold: float,
    top_k: int,
    Wc: int,
) -> CoarseMatches:
    """Selection over the (B, m_cap, n_cap) survivor grid; ids map back
    through t_idx (n_cap,) and p_idx (B, m_cap).  Returns (B, top_k)
    CoarseMatches."""
    B, m, n = raw_sub.shape
    t_idx, p_idx = t_idx.long(), p_idx.long()
    scale = _sim_scale(total_features[t_idx])
    vpos_sub = vpos_flat[p_idx][:, :, t_idx] & t_keep & p_keep[..., None]
    sim = torch.where(vpos_sub, raw_sub.to(torch.float32) * scale, -1.0)
    vals, fidx = _topk_first_index(sim.reshape(B, m * n), min(top_k, m * n))
    pos = torch.gather(p_idx, 1, torch.div(fidx, n, rounding_mode="floor"))
    return _coarse_matches(vals, t_idx[fidx % n], pos, Wc, threshold)


def coarse_scores_gemm_flat_batched_sub(
    Rb: torch.Tensor, W_gemm: MatmulWeight, idx: torch.Tensor, T: int, Kc: int
) -> torch.Tensor:
    """Exact coarse GEMM over survivor TEMPLATES only, every position:
    (B, Hc*Wc, n_cap) int32."""
    return coarse_scores_gemm_flat_batched(Rb, _gathered_weight(W_gemm, idx), T, Kc)


def select_candidates_flat_sub(
    raw_sub: torch.Tensor,
    total_features: torch.Tensor,
    vpos_flat: torch.Tensor,
    idx: torch.Tensor,
    keep: torch.Tensor,
    threshold: float,
    top_k: int,
    Wc: int,
) -> CoarseMatches:
    """Selection over survivor-compacted scores (B, Hc*Wc, n_cap):
    template ids map back through `idx`, dead slots mask to -1.  Returns
    (B, top_k) CoarseMatches."""
    B, P, n = raw_sub.shape
    idx = idx.long()
    scale = _sim_scale(total_features[idx])
    sim = torch.where(vpos_flat[:, idx] & keep, raw_sub.to(torch.float32) * scale, -1.0)
    vals, fidx = _topk_first_index(sim.reshape(B, P * n), min(top_k, P * n))
    return _coarse_matches(vals, idx[fidx % n],
                           torch.div(fidx, n, rounding_mode="floor"), Wc, threshold)


# ---------------------------------------------------------------------------
# Several classes in one pass (the two-object path)
# ---------------------------------------------------------------------------


def concat_level_features(
    feats_list: Sequence[LevelFeatures],
) -> tuple[LevelFeatures, tuple[int, ...]]:
    """Merge several classes' LevelFeatures into ONE template axis (each
    padded with dead slots to the widest Fmax).  Returns (merged, bases):
    class i owns rows [bases[i], bases[i+1]); subtract to re-base ids."""
    fmax = max(int(f.oris.shape[1]) for f in feats_list)
    pad = lambda a: torch.nn.functional.pad(
        a, (0, 0) * (a.dim() - 2) + (0, fmax - a.shape[1]))
    sizes = [int(f.oris.shape[0]) for f in feats_list]
    bases = tuple(sum(sizes[:i]) for i in range(len(sizes)))
    merged = LevelFeatures(
        offsets=torch.cat([pad(f.offsets) for f in feats_list]),
        oris=torch.cat([pad(f.oris) for f in feats_list]),
        live=torch.cat([pad(f.live) for f in feats_list]),
        count=torch.cat([f.count for f in feats_list]),
        size=torch.cat([f.size for f in feats_list]),
    )
    return merged, bases


def match_pooled_multiclass(
    Rb: torch.Tensor,
    W_gemm: MatmulWeight,
    W_cell: MatmulWeight,
    W_fine: MatmulWeight,
    total_features: torch.Tensor,
    vpos_flat: torch.Tensor,
    class_slices: Sequence[tuple[int, int]],
    thresholds: Sequence[float],
    T: int,
    Kc: int,
    g: int,
    pool1: int,
    pool2: int,
    top_k: int,
    Wc: int,
    r_cap: int = 128,
) -> tuple[list[CoarseMatches], list[torch.Tensor], PooledStats]:
    """The pooled matcher over a MERGED bank: one margin pass and one fine
    re-test, both at min(thresholds) (a survivor superset for every
    class), one exact pooled GEMM over the merged template axis, then one
    select per class over its own columns (`class_slices`) at its own
    threshold.  Fallbacks as in the single-class path, host branches as
    there.  Returns ([CoarseMatches (B, top_k) per class], [n_valid (B,)
    per class], PooledStats)."""
    if T % g != 0:
        raise ValueError(f"g={g} must divide T={T}")
    thr_min = min(thresholds)
    margins = position_margins_batched(
        Rb, W_cell, total_features, vpos_flat, thr_min, T, Kc)
    pp = pool_plan_from_margins(margins, pool1)
    # The reference computes this t_int from a Python float (a static
    # argument there): (thr - 1e-3) * 0.04 in double, rounded to f32 once.
    scale = torch.tensor((thr_min - 1e-3) * 0.04, dtype=torch.float32,
                         device=Rb.device)
    t_int = torch.ceil(scale * total_features.to(torch.float32) - 1e-4).to(torch.int32)
    classes = _class_columns(vpos_flat, class_slices, thresholds)
    return _pooled_selects(Rb, pp, t_int, W_gemm, W_fine, total_features,
                           vpos_flat, classes, T, Kc, g, pool1, pool2, top_k,
                           Wc, r_cap)


def _class_columns(vpos_flat: torch.Tensor, class_slices, thresholds):
    """(vpos_c, threshold_c) per class: the validity mask restricted to the
    class's own columns of the merged template axis."""
    col = torch.arange(vpos_flat.shape[1], device=vpos_flat.device)
    return [(vpos_flat & ((col >= lo) & (col < hi))[None, :], thr)
            for (lo, hi), thr in zip(class_slices, thresholds)]


def match_coarse_pruned_multiclass(
    Rb: torch.Tensor,
    W_gemm: MatmulWeight,
    W_cell: MatmulWeight,
    W_fine: MatmulWeight | None,
    total_features: torch.Tensor,
    vpos_flat: torch.Tensor,
    class_slices: Sequence[tuple[int, int]],
    thresholds: Sequence[float],
    T: int,
    Kc: int,
    m_cap: int,
    top_k: int,
    Wc: int,
    g: int | None = 4,
    m2_cap: int | None = None,
) -> tuple[list[CoarseMatches], PrunePlan]:
    """match_coarse_pruned_fine_with_fallback over a MERGED bank: one
    coarse prune and one fine re-test, both at min(thresholds) (a survivor
    superset for every class), one survivor GEMM over the merged template
    axis, then one select per class over its own columns at its own
    threshold.  Fallbacks as in the single-class path.  `W_fine=None` or
    `g=None` skips the fine stage.  Returns ([CoarseMatches (B, top_k) per
    class], PrunePlan)."""
    thr_min = min(thresholds)
    if g is not None and T % g != 0:
        raise ValueError(f"g={g} must divide T={T} (pass g=None to disable "
                         "the fine stage)")
    pp = prune_positions_batched(
        Rb, W_cell, total_features, vpos_flat, thr_min, T, Kc, m_cap)
    fine = g is not None and W_fine is not None
    cands, _ = _positions_selects(
        Rb, pp, W_gemm, W_fine, total_features, vpos_flat,
        _class_columns(vpos_flat, class_slices, thresholds), thr_min, T, Kc,
        g if fine else None,
        _default_cap(m2_cap, m_cap, "m2_cap") if fine else None, top_k, Wc)
    return cands, pp


def merge_candidates_sorted(
    cands: Sequence[CoarseMatches],
) -> tuple[CoarseMatches, torch.Tensor]:
    """Concatenate per-class (B, K) candidates and re-sort each frame so
    the valid candidates form ONE similarity-sorted prefix (the walk's
    skip needs it); ties keep the concatenated order, as the reference's
    top_k.  Returns (merged (B, sum K), n_valid (B,))."""
    cat = CoarseMatches(*(torch.cat(a, dim=1) for a in zip(*cands)))
    key = torch.where(cat.valid, cat.similarity, float("-inf"))
    _, idx = _topk_first_index(key, key.shape[1])
    merged = CoarseMatches(*(torch.gather(a, 1, idx) for a in cat))
    return merged, cat.valid.sum(dim=1).to(torch.int32)


def split_matches_by_class(
    m: Matches, class_slices: Sequence[tuple[int, int]], top_k: int
) -> list[Matches]:
    """Split walked merged-bank matches into per-class (B, top_k) records:
    a class's slots are the frame's top_k by similarity among its valid
    matches (ties in slot order), every slot's id re-based to the class's
    own bank, the filler's too."""
    out = []
    for lo, hi in class_slices:
        mine = m.valid & (m.template_id >= lo) & (m.template_id < hi)
        key = torch.where(mine, m.similarity, float("-inf"))
        _, idx = _topk_first_index(key, min(top_k, key.shape[1]))
        take = lambda a: torch.gather(a, 1, idx)
        out.append(Matches(template_id=take(m.template_id) - lo, x=take(m.x),
                           y=take(m.y), similarity=take(m.similarity),
                           valid=take(mine)))
    return out


# ---------------------------------------------------------------------------
# Exact local walk (kernel K3)
# ---------------------------------------------------------------------------


class WalkPlan(NamedTuple):
    """Per-slot operands of the walk for (B, K) candidates: K3's inputs
    (`operands`) plus what turns its scores into Matches."""

    t: torch.Tensor  # (B*K,) int64 template id
    cnt: torch.Tensor  # (B*K,) feature count
    gy0: torch.Tensor  # (B, K) int32 grid row of placement (0, 0)
    gx0: torch.Tensor  # (B, K) int32 grid col
    oris: torch.Tensor  # (B, K, F) int32
    dys: torch.Tensor  # (B, K, F) int32, clipped to [0, E0]
    dxs: torch.Tensor  # (B, K, F) int32
    live: torch.Tensor  # (B, K, F) bool
    n_valid: torch.Tensor  # (B,) int32 slots walked per frame

    def operands(self):
        return (self.oris, self.dys, self.dxs, self.live, self.gy0, self.gx0,
                self.n_valid)


def walk_plan(
    R0_shape, feats0: LevelFeatures, cand: CoarseMatches, coarse_T: int,
    E0: int, fine_T: int = 5, total_hw: tuple[int, int] | None = None,
    y_origin: int = 0, n_valid: torch.Tensor | None = None,
) -> WalkPlan:
    """cv::linemod's walk anchors: x1 = cell_x*T1 + (T1/2 + T1%2 - 1) at
    level 1, x = clamp(x1*2 + 1, 8*T0, W - tw - 8*T0), placements
    px = (x/T0 - 8 + c)*T0.  `n_valid` (B,) skips slots >= n_valid[b];
    frames whose valid mask is not the prefix [0, n_valid) walk all K."""
    B, C, H, W = R0_shape
    K = cand.template_id.shape[1]
    T = fine_T
    off_c = coarse_T // 2 + (coarse_T % 2 - 1)
    border = 8 * T
    Ht, Wt = total_hw if total_hw is not None else (H, W)
    dev = cand.template_id.device

    t = cand.template_id.reshape(-1).long()
    sz = feats0.size[t]
    x = (cand.cell_x.reshape(-1) * coarse_T + off_c) * 2 + 1
    y = (cand.cell_y.reshape(-1) * coarse_T + off_c) * 2 + 1
    x = torch.minimum(x.clamp(min=border), Wt - sz[:, 1] - border)
    y = torch.minimum(y.clamp(min=border), Ht - sz[:, 0] - border)
    gx0 = (torch.div(x, T, rounding_mode="floor") - 8).clamp(min=0)
    gy0 = (torch.div(y, T, rounding_mode="floor") - 8).clamp(min=0) - y_origin // T

    slot = torch.arange(K, device=dev, dtype=torch.int32)
    if n_valid is None:
        nv = torch.full((B,), K, dtype=torch.int32, device=dev)
    else:
        # Live-prefix guard: frames whose valid mask is NOT the sorted
        # prefix [0, n_valid) walk all K slots.
        pref = (cand.valid == (slot[None, :] < n_valid[:, None])).all(dim=1)
        nv = torch.where(pref, n_valid.to(torch.int32), K).to(torch.int32)

    offs = feats0.offsets[t]
    Fmax = offs.shape[1]
    i32 = lambda a, *shape: a.reshape(*shape).to(torch.int32).contiguous()
    return WalkPlan(
        t=t, cnt=feats0.count[t],
        gy0=i32(gy0, B, K), gx0=i32(gx0, B, K),
        oris=i32(feats0.oris[t], B, K, Fmax),
        dys=i32(offs[..., 0].clamp(0, E0), B, K, Fmax),
        dxs=i32(offs[..., 1].clamp(0, E0), B, K, Fmax),
        live=feats0.live[t].reshape(B, K, Fmax).contiguous(),
        n_valid=nv,
    )


def refine_candidates_opencv_batched(
    R0: torch.Tensor,
    feats0: LevelFeatures,
    cand: CoarseMatches,
    coarse_T: int,
    threshold: float,
    E0: int,
    fine_T: int = 5,
    total_hw: tuple[int, int] | None = None,
    y_origin: int = 0,
    n_valid: torch.Tensor | None = None,
    plain: bool = False,
) -> Matches:
    """cv::linemod's exact local-refinement walk over (B, K) candidates
    (anchors: walk_plan).  The template is scored at the 16 x 16 stride-T0
    placements, the first STRICT maximum in row-major order wins, and the
    reported position is px + (T0/2 + T0%2 - 1).  Scores come from K3 on
    the card (ops/cuda_kernels.walk_scores) or its plain version
    (`plain=True`, or CPU tensors); skipped slots score exactly 0."""
    from . import cuda_kernels as CK

    B, K = cand.template_id.shape
    T = fine_T
    WIN = CK.WIN
    off_f = T // 2 + (T % 2 - 1)
    plan = walk_plan(R0.shape, feats0, cand, coarse_T, E0, fine_T, total_hw,
                     y_origin, n_valid)
    walk = CK.walk_scores_plain if plain else CK.walk_scores
    flat = walk(R0, *plan.operands(), T).reshape(B * K, WIN * WIN)
    best = flat.argmax(dim=1)  # first maximum == OpenCV's strict-> walk
    raw = torch.gather(flat, 1, best[:, None])[:, 0]
    sim = 100.0 * raw.to(torch.float32) / (4.0 * plan.cnt.clamp(min=1).to(torch.float32))
    thr = torch.tensor(threshold, dtype=torch.float32, device=R0.device)
    ok = cand.valid.reshape(-1) & (sim >= thr)
    gx0, gy0 = plan.gx0.reshape(-1), plan.gy0.reshape(-1)
    shp = lambda a: a.reshape(B, K)
    return Matches(
        template_id=shp(plan.t.to(torch.int32)),
        x=shp(((gx0 + best % WIN) * T + off_f).to(torch.int32)),
        y=shp(((gy0 + torch.div(best, WIN, rounding_mode="floor")) * T
               + off_f + y_origin).to(torch.int32)),
        similarity=shp(sim),
        valid=shp(ok),
    )


# ---------------------------------------------------------------------------
# Window refiners (kernel K5): every offset of a dense window x window
# region around each coarse candidate, the LAST maximum wins
# ---------------------------------------------------------------------------
#
# Five ports of the reference's five window refiners.  They agree with
# each other while every feature offset is <= E0 - 1, which holds for
# every bank (extent() is the max offset + 1 rounded up to 8); each one
# keeps its own reference's offset clip so it also equals its counterpart
# beyond that: gather — none; slices — positions clipped to Hp - window;
# conv — offsets to [0, E0 - 1]; pallas — offsets to [0, E0].  The
# reference's conv is a batch-grouped int8 convolution (an MXU
# workaround); a direct window sum with the conv's clip is the same sum.


def _window_anchors(cand: CoarseMatches, coarse_T: int, fine_T: int, H: int,
                    W: int, min_y: int = 0):
    """Window origins (anchor_y, anchor_x): a coarse cell i covers level-0
    positions from i*2T on, the plateau reaches fine_T - 1 back."""
    ay = cand.cell_y * (coarse_T * 2) - (fine_T - 1)
    ax = cand.cell_x * (coarse_T * 2) - (fine_T - 1)
    return ay.clamp(min=min_y).clamp(max=H - 1), ax.clamp(0, W - 1)


def _window_matches(scores, t, cnt, ay, ax, valid, threshold: float) -> Matches:
    """Matches from raw (K, window, window) scores: the LAST maximum in
    row-major order (spreading covers forward offsets only, so a plateau
    extends toward the top-left of the true position), sim = 100 raw /
    (4 max(nf, 1))."""
    K, window = scores.shape[:2]
    flat = scores.reshape(K, -1)
    best = flat.shape[1] - 1 - flat.flip(1).argmax(dim=1)  # argmax: first max
    raw = torch.gather(flat, 1, best[:, None])[:, 0]
    sim = 100.0 * raw.to(torch.float32) / (4.0 * cnt.clamp(min=1).to(torch.float32))
    thr = torch.tensor(threshold, dtype=torch.float32, device=scores.device)
    return Matches(
        template_id=t.to(torch.int32),
        x=(ax + best % window).to(torch.int32),
        y=(ay + torch.div(best, window, rounding_mode="floor")).to(torch.int32),
        similarity=sim,
        valid=valid & (sim >= thr),
    )


def _window_refine(R0, feats0, cand, coarse_T, threshold, fine_T, window,
                   origins, min_y: int = 0) -> Matches:
    """Single-frame window refiner over (K,) candidates: `origins(ay, ax,
    offs)` gives each feature's window origin (K, F) — the refiner's own
    clip — and live slots are summed by the plain window sum."""
    from . import cuda_kernels as CK

    C, H, W = R0.shape
    ay, ax = _window_anchors(cand, coarse_T, fine_T, H, W, min_y)
    t = cand.template_id.long()
    ys, xs = origins(ay, ax, feats0.offsets[t])
    frame = torch.zeros(t.shape[0], dtype=torch.int32, device=R0.device)
    scores = CK.window_sums(R0[None], frame, feats0.oris[t], ys, xs,
                            feats0.live[t], window)
    return _window_matches(scores, t, feats0.count[t], ay, ax, cand.valid, threshold)


def refine_candidates(
    R0: torch.Tensor,
    feats0: LevelFeatures,
    cand: CoarseMatches,
    coarse_T: int,
    threshold: float,
    fine_T: int = 5,
    window: int = 24,
) -> Matches:
    """The gather refiner: (C, H, W) responses, (K,) candidates; feature
    offsets unclipped, reads outside the frame (either side) count 0.
    The reference gathers all (K, F, window, window) reads at once; here
    one feature slot at a time (the same integer sum)."""
    return _window_refine(
        R0, feats0, cand, coarse_T, threshold, fine_T, window,
        lambda ay, ax, offs: (ay[:, None] + offs[..., 0], ax[:, None] + offs[..., 1]))


def refine_candidates_slices(
    R0: torch.Tensor,
    feats0: LevelFeatures,
    cand: CoarseMatches,
    coarse_T: int,
    threshold: float,
    E0: int = 256,
    fine_T: int = 5,
    window: int = 24,
    anchor_min_y: int = 0,
) -> Matches:
    """The slice refiner: each feature's window slices a frame padded by
    window + E0 (bottom/right), its origin clipped to [0, Hp - window];
    `anchor_min_y` raises the anchor row's lower clip (the row-sharded
    matcher's halo)."""
    C, H, W = R0.shape
    Hp, Wp = H + window + E0, W + window + E0

    def origins(ay, ax, offs):
        return ((ay[:, None] + offs[..., 0]).clamp(0, Hp - window),
                (ax[:, None] + offs[..., 1]).clamp(0, Wp - window))

    return _window_refine(R0, feats0, cand, coarse_T, threshold, fine_T, window,
                          origins, min_y=anchor_min_y)


def refine_candidates_conv(
    R0: torch.Tensor,
    feats0: LevelFeatures,
    cand: CoarseMatches,
    coarse_T: int,
    threshold: float,
    E0: int,
    fine_T: int = 5,
    window: int = 24,
) -> Matches:
    """The reference's one-hot-filter convolution refiner, as the direct
    window sum it computes: offsets clipped to [0, E0 - 1] (its filter
    size), reads past the frame 0."""
    return _window_refine(
        R0, feats0, cand, coarse_T, threshold, fine_T, window,
        lambda ay, ax, offs: (ay[:, None] + offs[..., 0].clamp(0, E0 - 1),
                              ax[:, None] + offs[..., 1].clamp(0, E0 - 1)))


class WindowPlan(NamedTuple):
    """K5's operands for K candidates (flattened over frames), plus what
    turns its scores into Matches."""

    t: torch.Tensor  # (K,) int64 template id
    nf: torch.Tensor  # (K,) int32 feature count: slots [0, nf) are summed
    anchor_y: torch.Tensor  # (K,) int32 window origin
    anchor_x: torch.Tensor  # (K,) int32
    oris: torch.Tensor  # (K, F) int32, live slots first
    dys: torch.Tensor  # (K, F) int32, clipped to [0, E0]
    dxs: torch.Tensor  # (K, F) int32
    frame_idx: torch.Tensor | None  # (K,) int32 (batched R0), else None

    def operands(self):
        return (self.oris, self.dys, self.dxs, self.nf, self.anchor_y, self.anchor_x)


def window_plan(R0_shape, feats0: LevelFeatures, cand: CoarseMatches,
                coarse_T: int, E0: int, fine_T: int = 5) -> WindowPlan:
    """K5's operands: (C, H, W) with (K,) candidates, or (B, C, H, W) with
    (B, K) candidates (each slot reads its own frame).  Each candidate's
    feature slots are compacted live-first, since K5 sums slots f < nf."""
    H, W = R0_shape[-2:]
    flat = CoarseMatches(*(a.reshape(-1) for a in cand))
    ay, ax = _window_anchors(flat, coarse_T, fine_T, H, W)
    t = flat.template_id.long()
    offs, oris, _ = _compact_live_slots(feats0.offsets[t], feats0.oris[t], feats0.live[t])
    frame = None
    if len(R0_shape) == 4:
        B, K = cand.template_id.shape
        frame = torch.arange(B, dtype=torch.int32, device=t.device).repeat_interleave(K)
    i32 = lambda a: a.to(torch.int32).contiguous()
    return WindowPlan(
        t=t, nf=i32(feats0.count[t]), anchor_y=i32(ay), anchor_x=i32(ax),
        oris=i32(oris), dys=i32(offs[..., 0].clamp(0, E0)),
        dxs=i32(offs[..., 1].clamp(0, E0)), frame_idx=frame,
    )


def _refine_k5(R0, feats0, cand, coarse_T, threshold, E0, fine_T, window,
               plain) -> Matches:
    from . import cuda_kernels as CK

    plan = window_plan(R0.shape, feats0, cand, coarse_T, E0, fine_T)
    k5 = CK.refine_scores_plain if plain else CK.refine_scores
    scores = k5(R0, *plan.operands(), window=window, frame_idx=plan.frame_idx)
    return _window_matches(scores, plan.t, plan.nf, plan.anchor_y, plan.anchor_x,
                           cand.valid.reshape(-1), threshold)


def refine_candidates_pallas(
    R0: torch.Tensor,
    feats0: LevelFeatures,
    cand: CoarseMatches,
    coarse_T: int,
    threshold: float,
    E0: int,
    fine_T: int = 5,
    window: int = 24,
    plain: bool = False,
) -> Matches:
    """The K5 refiner over one frame: (C, H, W) responses, (K,)
    candidates; offsets clipped to [0, E0].  Scores come from K5 on the
    card (ops/cuda_kernels.refine_scores) or its plain version
    (`plain=True`, or CPU tensors)."""
    return _refine_k5(R0, feats0, cand, coarse_T, threshold, E0, fine_T, window, plain)


def refine_candidates_pallas_batched(
    R0: torch.Tensor,
    feats0: LevelFeatures,
    cand: CoarseMatches,
    coarse_T: int,
    threshold: float,
    E0: int,
    fine_T: int = 5,
    window: int = 24,
    plain: bool = False,
) -> Matches:
    """The K5 refiner over a frame batch: (B, C, H, W) responses, (B, K)
    candidates, ONE K5 launch over all B*K (each reads its own frame)."""
    B, K = cand.template_id.shape
    m = _refine_k5(R0, feats0, cand, coarse_T, threshold, E0, fine_T, window, plain)
    return Matches(*(a.reshape(B, K) for a in m))


# ---------------------------------------------------------------------------
# Frame preprocessing: quantize + spread + respond at both pyramid levels
# ---------------------------------------------------------------------------


class FramePyramid(NamedTuple):
    """Response maps per level per modality (None when depth is unused):
    channel views of the stacks that preprocess_frames_batched returns."""

    grad_r0: torch.Tensor  # (..., 8, H, W) u8
    grad_r1: torch.Tensor  # (..., 8, H/2, W/2) u8
    norm_r0: torch.Tensor
    norm_r1: torch.Tensor


def preprocess_frames_batched(
    rgbs: torch.Tensor,  # (B, H, W, 3) uint8
    depths_mm: torch.Tensor | None,  # (B, H, W) f32 or None
    T0: int = 5,
    T1: int = 8,
    use_depth: bool = False,
    weak_threshold: float = 10.0,
    plain: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched preprocess -> channel-stacked (R0, R1) response tensors
    ((B, C, H, W), (B, C, H/2, W/2) u8; C = 16 with DepthNormal, else 8:
    ColorGradient at channels 0-7, DepthNormal at 8-15).

    K1 quantizes ColorGradient at both levels (the level-1 input is the
    integer-valued f32 pyrDown output) and K2 spreads + responds four
    times per batch, writing each modality's 8 planes straight into its
    channel slice of the stacks, so no concatenation pass follows.
    `plain=True` takes the plain PyTorch versions on any device (CPU
    tensors always do).  DepthNormal quantizes in plain PyTorch; level 1
    subsamples the level-0 quantized normals (the engine's
    DepthNormalPyramid::pyrDown)."""
    from . import cuda_kernels as CK
    from . import cuda_preprocess as CP

    if use_depth and depths_mm is None:
        raise ValueError(
            "use_depth=True requires depths_mm (B, H, W) in millimetres"
        )
    if plain:
        quant = lambda x: F.quantize_color_gradient(x, weak_threshold)[0]
        respond = CK.spread_response_plain
    else:
        quant = lambda x: CP.quantize_color_gradient(x, weak_threshold)
        respond = CK.spread_response
    B, H, W = rgbs.shape[:3]
    C = 16 if use_depth else 8
    R0 = torch.empty((B, C, H, W), dtype=torch.uint8, device=rgbs.device)
    respond(quant(rgbs), T0, R0, 0)
    chans = [F.pyr_down(rgbs[..., c].to(torch.float32)) for c in range(3)]
    rgb1 = torch.empty((*chans[0].shape, 3), dtype=torch.float32, device=rgbs.device)
    for c, ch in enumerate(chans):
        rgb1[..., c] = ch
    R1 = torch.empty((B, C, *rgb1.shape[1:3]), dtype=torch.uint8, device=rgbs.device)
    respond(quant(rgb1), T1, R1, 0)
    if use_depth:
        n0 = F.quantize_depth_normal(depths_mm)
        respond(n0, T0, R0, 8)
        respond(n0[:, ::2, ::2].contiguous(), T1, R1, 8)
    return R0, R1


def preprocess_pyramid_batched(
    rgbs: torch.Tensor,  # (B, H, W, 3) uint8
    depths_mm: torch.Tensor | None,  # (B, H, W) f32 or None
    T0: int = 5,
    T1: int = 8,
    use_depth: bool = False,
    weak_threshold: float = 10.0,
    plain: bool = False,
) -> FramePyramid:
    """Batched preprocess -> per-modality response maps at both levels
    ((B, 8, H, W) and (B, 8, H/2, W/2) u8; the norm fields are None when
    `use_depth` is off): channel views of preprocess_frames_batched's
    stacks."""
    R0, R1 = preprocess_frames_batched(rgbs, depths_mm, T0, T1, use_depth,
                                       weak_threshold, plain)
    if use_depth:
        return FramePyramid(R0[:, :8], R1[:, :8], R0[:, 8:], R1[:, 8:])
    return FramePyramid(R0, R1, None, None)


def preprocess_frame(
    rgb: torch.Tensor,  # (H, W, 3) uint8
    depth_mm: torch.Tensor | None,  # (H, W) f32 or None
    T0: int = 5,
    T1: int = 8,
    use_depth: bool = False,
    weak_threshold: float = 10.0,
    plain: bool = False,
) -> FramePyramid:
    """One frame -> response-map pyramid ((8, H, W) / (8, H/2, W/2) u8 per
    modality): the B=1 call of preprocess_pyramid_batched, so K1 and K2
    launch on the card (the B=1 K2 launches are the port of the
    reference's single-frame K2, ``pallas_kernels.py::spread_response``).
    The norm maps are zeros when depth is not used, as in the reference."""
    use_depth = use_depth and depth_mm is not None
    pyr = preprocess_pyramid_batched(
        rgb[None], None if depth_mm is None else depth_mm[None], T0, T1,
        use_depth, weak_threshold, plain)
    g_r0, g_r1 = pyr.grad_r0[0], pyr.grad_r1[0]
    if not use_depth:
        return FramePyramid(g_r0, g_r1, torch.zeros_like(g_r0), torch.zeros_like(g_r1))
    return FramePyramid(g_r0, g_r1, pyr.norm_r0[0], pyr.norm_r1[0])


# ---------------------------------------------------------------------------
# Single-frame matching (Detector.match_raw)
# ---------------------------------------------------------------------------


def coarse_scores_gemm_flat(R: torch.Tensor, W_gemm: MatmulWeight, T: int,
                            Kc: int) -> torch.Tensor:
    """(C, H, W) responses -> raw scores (Hc*Wc, N) int32 of every template
    at every T-strided position, position-major: the exact int8 GEMM of
    one frame."""
    return coarse_scores_gemm_flat_batched(R[None], W_gemm, T, Kc)[0]


def coarse_scores_gemm(R: torch.Tensor, W_gemm: MatmulWeight, T: int,
                       Kc: int) -> torch.Tensor:
    """coarse_scores_gemm_flat, template-major (N, Hc, Wc) as the reference
    returns it."""
    C, H, W = R.shape
    return coarse_scores_gemm_flat(R, W_gemm, T, Kc).t().reshape(-1, H // T, W // T)


def select_candidates(raw: torch.Tensor, total_features: torch.Tensor,
                      valid_pos: torch.Tensor, threshold: float, top_k: int
                      ) -> CoarseMatches:
    """Threshold + top-k over the (N, Hc, Wc) coarse score volume, flat in
    the reference's TEMPLATE-major order (ties: the lower flat index
    first).  sim = 100 raw / (4 max(nf, 1)), divided tensor by tensor."""
    N, Hc, Wc = raw.shape
    den = 4.0 * total_features.clamp(min=1).to(torch.float32)
    sim = 100.0 * raw.to(torch.float32) / den[:, None, None]
    sim = torch.where(valid_pos, sim, -1.0).reshape(-1)
    vals, idx = _topk_first_index(sim, min(top_k, sim.shape[0]))
    t = torch.div(idx, Hc * Wc, rounding_mode="floor")
    rem = idx % (Hc * Wc)
    thr = torch.tensor(threshold, dtype=torch.float32, device=raw.device)
    return CoarseMatches(
        t.to(torch.int32),
        torch.div(rem, Wc, rounding_mode="floor").to(torch.int32),
        (rem % Wc).to(torch.int32),
        vals,
        vals >= thr,
    )


def refine_candidates_opencv(
    R0: torch.Tensor,
    feats0: LevelFeatures,
    cand: CoarseMatches,
    coarse_T: int,
    threshold: float,
    E0: int,
    fine_T: int = 5,
    plain: bool = False,
) -> Matches:
    """Single-frame walk: the B=1 call of refine_candidates_opencv_batched
    over every candidate slot (K3 at B=1 on the card)."""
    m = refine_candidates_opencv_batched(
        R0[None], feats0, CoarseMatches(*(a[None] for a in cand)), coarse_T,
        threshold, E0, fine_T, plain=plain,
    )
    return Matches(*(a[0] for a in m))
