"""Batched multi-camera serving: B frames through the match engine per
step — the port of ``linemod_pose_estimation_tpu/models/serving.py``'s
BatchedMatcher and MultiClassBatchedMatcher.

A BatchedMatcher step: batched preprocess (K1 + K2 on the card), then
either the batch-shared survivor pool with its exact exhaustive fallback
(``prune_mode="pooled"``, the production path;
ops.match.match_pooled_fine_with_fallback) or, by default
(``prune=False``), the exhaustive int8 GEMM and a per-frame top-k; then
cv::linemod's exact walk (K3).  `candidates()` and `refine()` split the
step, so the window refiners (K5, ops.match.refine_candidates_pallas_
batched) can run on the same candidates.  The reference module's
docstring ("ONE Pallas refinement dispatch") predates its K3 walk: the
reference's match_batch walks, it does not call the window refiners.

MultiClassBatchedMatcher (pooled mode) serves several classes from one
preprocess, one pooled pass over the merged bank and one walk.

Not ported yet: the `positions` and `two_axis` prune modes,
PipelinedRunner, look_at_point and template_refinement.
"""

from __future__ import annotations

import torch

from ..ops import match as M
from ..utils.device import DEFAULT_DEVICE, resolve_device


def slice_settings(batch: int, height: int = 480, width: int = 640,
                   T1: int = 8) -> dict:
    """BatchedMatcher keyword arguments of the production pooled path at
    batch B (the reference bench's headline): top_k 128, fine_g 4,
    pool_coarse 56 B, pool_fine 36 B, sel_row_cap 128, group bound 16.

    The group tier's pool is every level-1 position of the batch
    (B * Hc * Wc), not the bench's 2 * pool_coarse: on RGB-D scenes whose
    background is a flat depth plane, the group-max bound over 16 views
    clears the threshold almost everywhere (every position of every frame
    on the committed scenes), so a 2 * pool_coarse pool overflows on every
    batch and the exhaustive fallback always runs."""
    P = (height // 2 // T1) * (width // 2 // T1)
    return dict(top_k=128, prune=True, prune_mode="pooled", fine_g=4,
                pool_coarse=56 * batch, pool_fine=36 * batch, sel_row_cap=128,
                group_bound=16, pool_group=batch * P)


def _frames(rgbs, depths_mm, use_depth: bool, device):
    """The batch as tensors on `device`; depth is required by a
    DepthNormal bank."""
    if use_depth and depths_mm is None:
        raise ValueError(
            "this bank uses the DepthNormal modality: match_batch "
            "requires depths_mm (B, H, W) in millimetres"
        )
    rgbs = torch.as_tensor(rgbs, device=device)
    if depths_mm is not None:
        depths_mm = torch.as_tensor(depths_mm, device=device)
    return rgbs, depths_mm


class BatchedMatcher:
    """Two modes are ported.  `prune=False` (the default) scores every
    position of every template with ONE exhaustive int8 GEMM over the
    batch, selects each frame's top_k and walks all of them.
    `prune_mode="pooled"` (with `prune=True`) runs ONE batch-shared
    frame-major survivor pool per stage; `pool_coarse` / `pool_fine` size
    the two pools (None -> 64/32 slots per batch frame), `sel_row_cap`
    bounds the per-frame select range, `group_bound` turns on the
    group-max pre-bound with a `pool_group`-slot pool (None -> 2 x
    pool_coarse).  Results are unconditionally exact: any overflow runs
    the exhaustive GEMM.  In pooled mode `self.last_pool` (a PooledStats)
    reports true survivor totals and any fallback of the most recent
    batch, and `self.last_n_valid` its per-frame count of valid
    candidates; the walk skips the slots past it.

    `device` places the bank operands and the computation.  `plain=True`
    runs the plain PyTorch versions of K1/K2/K3 even on the card — the
    path the kernels are checked against."""

    def __init__(self, detector, class_id: str, threshold: float, batch: int,
                 top_k: int = 256, prune: bool = False,
                 prune_mode: str = "positions", fine_g: int | None = 4,
                 pool_coarse: int | None = None, pool_fine: int | None = None,
                 sel_row_cap: int = 128, group_bound: int | None = None,
                 pool_group: int | None = None, device=DEFAULT_DEVICE,
                 plain: bool = False):
        if prune and prune_mode != "pooled":
            raise NotImplementedError(
                f"prune_mode={prune_mode!r} is not ported (ported: prune=False, "
                "and prune=True with prune_mode='pooled')")
        if prune_mode == "pooled" and not prune:
            raise ValueError("prune_mode='pooled' requires prune=True")
        p = detector.params
        bank = detector.bank(class_id)
        self.device = resolve_device(device)
        self.T0, self.T1 = p.t_pyramid
        self.prune = prune
        self.threshold = threshold
        self.top_k = top_k
        self.batch = batch
        self.fine_g = fine_g
        self.Kc1 = bank.max_cell_extent(1)
        self.E0 = bank.extent(0)
        self.feats1 = bank.merged_features(1).to(self.device)
        self.feats0 = bank.merged_features(0).to(self.device)
        self.use_depth = p.use_depth_normal
        self.weak = p.color.weak_threshold
        self.plain = plain
        C = 8 * bank.num_modalities
        self._vpos: dict[tuple[int, int], torch.Tensor] = {}
        self.last_pool: M.PooledStats | None = None
        self.last_n_valid: torch.Tensor | None = None
        if not prune:
            self.W_gemm = M.MatmulWeight.from_kn(
                M.build_gemm_weights(self.feats1, C, self.T1, self.Kc1))
            return
        if not fine_g or self.T1 % fine_g:
            raise ValueError("prune_mode='pooled' requires a fine_g that "
                             f"divides T1={self.T1}")
        self.pool_coarse = pool_coarse if pool_coarse is not None else 64 * batch
        self.pool_fine = pool_fine if pool_fine is not None else 32 * batch
        self.sel_row_cap = sel_row_cap
        self.group_bound = group_bound
        self.pool_group = pool_group if pool_group is not None \
            else 2 * self.pool_coarse
        self.weights = M.build_bank_weights(
            self.feats1, C, self.T1, self.Kc1, fine_g, group_bound)
        self.W_gemm = self.weights.W_gemm

    def _vpos_flat(self, Hc: int, Wc: int) -> torch.Tensor:
        if (Hc, Wc) not in self._vpos:
            self._vpos[(Hc, Wc)] = M.position_validity_flat(
                self.feats1.size, self.T1, Hc, Wc)
        return self._vpos[(Hc, Wc)]

    def candidates(self, rgbs, depths_mm=None):
        """Preprocess + exact candidate selection: (R0, CoarseMatches (B,
        top_k), n_valid (B,) in pooled mode, else None) — the first half
        of match_batch."""
        rgbs, depths_mm = _frames(rgbs, depths_mm, self.use_depth, self.device)
        T1 = self.T1
        R0, R1 = M.preprocess_frames_batched(
            rgbs, depths_mm, T0=self.T0, T1=T1, use_depth=self.use_depth,
            weak_threshold=self.weak, plain=self.plain)
        Hc, Wc = R1.shape[2] // T1, R1.shape[3] // T1
        vpos = self._vpos_flat(Hc, Wc)
        thr = self.threshold - 5.0  # the coarse gate, 5 below the reported one
        if not self.prune:
            raw = M.coarse_scores_gemm_flat_batched(R1, self.W_gemm, T1, self.Kc1)
            cands = M.select_candidates_flat(raw, self.feats1.count, vpos, thr,
                                             self.top_k, Wc)
            return R0, cands, None
        w = self.weights
        group = {}
        if w.W_group is not None:
            group = dict(W_group=w.W_group, group_counts=w.group_counts,
                         pool0=self.pool_group, group=self.group_bound)
        cands, n_valid, stats = M.match_pooled_fine_with_fallback(
            R1, w.W_gemm, w.W_cell, w.W_fine, self.feats1.count, vpos, thr, T1,
            self.Kc1, self.fine_g, self.pool_coarse, self.pool_fine, self.top_k,
            Wc, r_cap=self.sel_row_cap, **group,
        )
        self.last_pool = stats
        self.last_n_valid = n_valid
        return R0, cands, n_valid

    def refine(self, R0, cands, n_valid=None) -> M.Matches:
        """cv::linemod's exact walk over each frame's candidates (only the
        valid prefix with `n_valid`) — the second half of match_batch."""
        return M.refine_candidates_opencv_batched(
            R0, self.feats0, cands, self.T1, self.threshold, E0=self.E0,
            fine_T=self.T0, n_valid=n_valid, plain=self.plain,
        )

    def match_batch(self, rgbs, depths_mm=None) -> M.Matches:
        """(B, H, W, 3) uint8 [+ (B, H, W) depth mm] -> batched Matches with
        (B, top_k) tensors on the matcher's device (mask by .valid)."""
        return self.refine(*self.candidates(rgbs, depths_mm))


class MultiClassBatchedMatcher:
    """Several object classes per frame batch through ONE pipeline: the
    classes' template axes are concatenated (ops.match.concat_level_
    features), so one preprocess, one pooled pass at min(thresholds)
    (ops.match.match_pooled_multiclass), one exact GEMM and one walk over
    the merged, re-sorted candidates serve every class; only the select
    runs per class, at the class's threshold - 5, and each class's walked
    matches are re-gated at its own threshold.  `prune_mode="pooled"` is
    the one ported mode; pools as in BatchedMatcher (no group tier, as in
    the reference).  `self.last_pool` holds the batch's PooledStats.
    `device` and `plain` as in BatchedMatcher."""

    def __init__(self, detector, class_ids: list[str], thresholds, batch: int,
                 top_k: int = 256, fine_g: int | None = 4,
                 prune_mode: str = "positions",
                 pool_coarse: int | None = None, pool_fine: int | None = None,
                 sel_row_cap: int = 128, device=DEFAULT_DEVICE, plain: bool = False):
        if prune_mode != "pooled":
            raise NotImplementedError(
                f"prune_mode={prune_mode!r} is not ported (ported: 'pooled')")
        if isinstance(thresholds, (int, float)):
            thresholds = [float(thresholds)] * len(class_ids)
        if len(thresholds) != len(class_ids):
            raise ValueError("need one threshold per class")
        p = detector.params
        self.device = resolve_device(device)
        self.class_ids = list(class_ids)
        self.thresholds = [float(t) for t in thresholds]
        self.T0, self.T1 = p.t_pyramid
        if not fine_g or self.T1 % fine_g:
            raise ValueError("prune_mode='pooled' requires a fine_g that "
                             f"divides T1={self.T1}")
        self.top_k = top_k
        self.batch = batch
        self.fine_g = fine_g
        self.use_depth = p.use_depth_normal
        self.weak = p.color.weak_threshold
        self.pool_coarse = pool_coarse if pool_coarse is not None else 64 * batch
        self.pool_fine = pool_fine if pool_fine is not None else 32 * batch
        self.sel_row_cap = sel_row_cap
        self.plain = plain
        self.last_pool: M.PooledStats | None = None

        banks = [detector.bank(c) for c in class_ids]
        n_mod = {b.num_modalities for b in banks}
        if len(n_mod) != 1:
            raise ValueError("every class's bank must use the same modalities")
        C = 8 * n_mod.pop()
        self.Kc1 = max(b.max_cell_extent(1) for b in banks)
        self.E0 = max(b.extent(0) for b in banks)
        f1, bases = M.concat_level_features([b.merged_features(1) for b in banks])
        f0, _ = M.concat_level_features([b.merged_features(0) for b in banks])
        self.feats1, self.feats0 = f1.to(self.device), f0.to(self.device)
        ends = bases[1:] + (int(f1.count.shape[0]),)
        self.slices = tuple(zip(bases, ends))
        W_cell = M.build_cell_weights(self.feats1, C, self.T1, self.Kc1)
        self.W_gemm = M.MatmulWeight.from_kn(
            M.build_gemm_weights(self.feats1, C, self.T1, self.Kc1))
        self.W_cell = M.MatmulWeight.from_nk(W_cell)
        self.W_fine = M.MatmulWeight.from_nk(M.build_cell_weights_fine(
            self.feats1, C, self.T1, self.Kc1, fine_g))

    def candidates(self, rgbs, depths_mm=None):
        """Preprocess + the pooled pass over the merged bank: (R0, [CoarseMatches
        (B, top_k) per class]) — the first half of match_batch."""
        rgbs, depths_mm = _frames(rgbs, depths_mm, self.use_depth, self.device)
        T1 = self.T1
        R0, R1 = M.preprocess_frames_batched(
            rgbs, depths_mm, T0=self.T0, T1=T1, use_depth=self.use_depth,
            weak_threshold=self.weak, plain=self.plain)
        Hc, Wc = R1.shape[2] // T1, R1.shape[3] // T1
        vpos = M.position_validity_flat(self.feats1.size, T1, Hc, Wc)
        cands, _, stats = M.match_pooled_multiclass(
            R1, self.W_gemm, self.W_cell, self.W_fine, self.feats1.count, vpos,
            self.slices, [t - 5.0 for t in self.thresholds], T1, self.Kc1,
            self.fine_g, self.pool_coarse, self.pool_fine, self.top_k, Wc,
            r_cap=self.sel_row_cap,
        )
        self.last_pool = stats
        return R0, cands

    def refine(self, R0, cands) -> dict[str, M.Matches]:
        """One walk over the merged valid prefix of every class, gated at
        the loosest threshold, then each class's split re-gated at its own
        — the second half of match_batch."""
        cat, n_valid = M.merge_candidates_sorted(cands)
        m = M.refine_candidates_opencv_batched(
            R0, self.feats0, cat, self.T1, min(self.thresholds), E0=self.E0,
            fine_T=self.T0, n_valid=n_valid, plain=self.plain,
        )
        out = {}
        for cid, mc, thr in zip(self.class_ids,
                                M.split_matches_by_class(m, self.slices, self.top_k),
                                self.thresholds):
            ok = mc.valid & (mc.similarity >= torch.tensor(
                thr, dtype=torch.float32, device=self.device))
            out[cid] = mc._replace(valid=ok)
        return out

    def match_batch(self, rgbs, depths_mm=None) -> dict[str, M.Matches]:
        """(B, H, W, 3) uint8 [+ (B, H, W) mm] -> {class_id: Matches} with
        (B, top_k) tensors, template ids re-based per class."""
        return self.refine(*self.candidates(rgbs, depths_mm))
