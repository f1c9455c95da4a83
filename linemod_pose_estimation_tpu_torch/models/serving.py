"""Batched multi-camera serving: B frames through the match engine per
step — the pooled mode of ``linemod_pose_estimation_tpu/models/serving.py
::BatchedMatcher``, the production path.

One step: batched preprocess (K1 + K2 on the card), the batch-shared
survivor pool with its exact exhaustive fallback
(ops.match.match_pooled_fine_with_fallback), then cv::linemod's exact
walk (K3) over the valid prefix of each frame's candidates.  The
`positions` and `two_axis` prune modes, MultiClassBatchedMatcher and
PipelinedRunner are not ported yet.
"""

from __future__ import annotations

import torch

from ..ops import match as M


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


class BatchedMatcher:
    """`prune_mode="pooled"` (with `prune=True`) is the one ported mode:
    ONE batch-shared frame-major survivor pool per stage; `pool_coarse` /
    `pool_fine` size the two pools (None -> 64/32 slots per batch frame),
    `sel_row_cap` bounds the per-frame select range, `group_bound` turns
    on the group-max pre-bound with a `pool_group`-slot pool (None -> 2 x
    pool_coarse).  Results are unconditionally exact: any overflow runs
    the exhaustive GEMM.  `self.last_pool` (a PooledStats) reports true
    survivor totals and any fallback of the most recent batch, and
    `self.last_n_valid` its per-frame count of valid candidates.

    `device` places the bank operands and the computation.  `plain=True`
    runs the plain PyTorch versions of K1/K2/K3 even on the card — the
    path the kernels are checked against."""

    def __init__(self, detector, class_id: str, threshold: float, batch: int,
                 top_k: int = 256, prune: bool = False,
                 prune_mode: str = "positions", fine_g: int | None = 4,
                 pool_coarse: int | None = None, pool_fine: int | None = None,
                 sel_row_cap: int = 128, group_bound: int | None = None,
                 pool_group: int | None = None, device="cpu",
                 plain: bool = False):
        if prune_mode != "pooled" or not prune:
            raise NotImplementedError(
                "only prune=True, prune_mode='pooled' is ported")
        p = detector.params
        bank = detector.bank(class_id)
        self.device = torch.device(device)
        self.T0, self.T1 = p.t_pyramid
        if not fine_g or self.T1 % fine_g:
            raise ValueError("prune_mode='pooled' requires a fine_g that "
                             f"divides T1={self.T1}")
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
        self.pool_coarse = pool_coarse if pool_coarse is not None else 64 * batch
        self.pool_fine = pool_fine if pool_fine is not None else 32 * batch
        self.sel_row_cap = sel_row_cap
        self.group_bound = group_bound
        self.pool_group = pool_group if pool_group is not None \
            else 2 * self.pool_coarse
        self.plain = plain
        n_mod = 2 if self.use_depth else 1
        self.weights = M.build_bank_weights(
            self.feats1, 8 * n_mod, self.T1, self.Kc1, fine_g, group_bound)
        self._vpos: dict[tuple[int, int], torch.Tensor] = {}
        self.last_pool: M.PooledStats | None = None
        self.last_n_valid: torch.Tensor | None = None

    def _vpos_flat(self, Hc: int, Wc: int) -> torch.Tensor:
        if (Hc, Wc) not in self._vpos:
            self._vpos[(Hc, Wc)] = M.position_validity_flat(
                self.feats1.size, self.T1, Hc, Wc)
        return self._vpos[(Hc, Wc)]

    def candidates(self, rgbs, depths_mm=None):
        """Preprocess + pooled exact matching: (R0, CoarseMatches (B, top_k),
        n_valid (B,)) — the first half of match_batch."""
        if self.use_depth and depths_mm is None:
            raise ValueError(
                "this bank uses the DepthNormal modality: match_batch "
                "requires depths_mm (B, H, W) in millimetres"
            )
        rgbs = torch.as_tensor(rgbs, device=self.device)
        if depths_mm is not None:
            depths_mm = torch.as_tensor(depths_mm, device=self.device)
        T1 = self.T1
        R0, R1 = M.preprocess_frames_batched(
            rgbs, depths_mm, T0=self.T0, T1=T1, use_depth=self.use_depth,
            weak_threshold=self.weak, plain=self.plain)
        Hc, Wc = R1.shape[2] // T1, R1.shape[3] // T1
        w = self.weights
        group = {}
        if w.W_group is not None:
            group = dict(W_group=w.W_group, group_counts=w.group_counts,
                         pool0=self.pool_group, group=self.group_bound)
        cands, n_valid, stats = M.match_pooled_fine_with_fallback(
            R1, w.W_gemm, w.W_cell, w.W_fine, self.feats1.count,
            self._vpos_flat(Hc, Wc), self.threshold - 5.0, T1, self.Kc1,
            self.fine_g, self.pool_coarse, self.pool_fine, self.top_k, Wc,
            r_cap=self.sel_row_cap, **group,
        )
        self.last_pool = stats
        self.last_n_valid = n_valid
        return R0, cands, n_valid

    def refine(self, R0, cands, n_valid) -> M.Matches:
        """cv::linemod's exact walk over each frame's valid candidate
        prefix — the second half of match_batch."""
        return M.refine_candidates_opencv_batched(
            R0, self.feats0, cands, self.T1, self.threshold, E0=self.E0,
            fine_T=self.T0, n_valid=n_valid, plain=self.plain,
        )

    def match_batch(self, rgbs, depths_mm=None) -> M.Matches:
        """(B, H, W, 3) uint8 [+ (B, H, W) depth mm] -> batched Matches with
        (B, top_k) tensors on the matcher's device (mask by .valid)."""
        return self.refine(*self.candidates(rgbs, depths_mm))
