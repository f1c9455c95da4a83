"""Batched multi-camera serving: B frames through the match engine per
step — the port of ``linemod_pose_estimation_tpu/models/serving.py``'s
BatchedMatcher and MultiClassBatchedMatcher.

A BatchedMatcher step: batched preprocess (K1 + K2 on the card), then the
exact candidate selection in one of four ways — the exhaustive exact
scores and a per-frame top-k (``prune=False``, the default); per-frame survivor
caps with exact fallbacks (``prune=True``, ``prune_mode="positions"``,
ops.match.match_coarse_pruned_fine_with_fallback); a survivor grid on both
axes without a fallback (``"two_axis"``, ops.match.prune_plan_batched); or
the batch-shared survivor pool with its exhaustive fallback (``"pooled"``,
the production path, ops.match.match_pooled_fine_with_fallback) — then
cv::linemod's exact walk (K3).  `candidates()` and `refine()` split the
step, so the window refiners (K5, ops.match.refine_candidates_pallas_
batched) can run on the same candidates.  The reference module's
docstring ("ONE Pallas refinement dispatch") predates its K3 walk: the
reference's match_batch walks, it does not call the window refiners.

MultiClassBatchedMatcher serves several classes from one preprocess, one
pruned pass over the merged bank (per-frame caps by default, or the pool)
and one walk.

PipelinedRunner keeps up to `depth` steps in flight, each closed by a CUDA
event.  The carmine node's extras: look_at_point (the cloud point at a
detection's bbox centre, with a nearest-valid fallback) and
template_refinement (a re-render at the estimated pose, K4, and one more
two-stage ICP).
"""

from __future__ import annotations

from collections import deque

import torch

from ..ops import match as M
from ..ops.features import condition_frames
from ..ops.icp import icp_two_stage
from ..utils import pointcloud as pcu
from ..utils import tracing
from ..utils.device import DEFAULT_DEVICE, resolve_device


# Pool slots a frame (coarse, fine) of a one-modality bank, sized on the
# card from the Ensenso cell's traffic (colour-only bank x4 at 85, B=32): the
# fullest of 36 batches held 2221 coarse and 1311 fine survivors, 72% and
# 64% of these pools; 56 / 36 overflow on every batch.
POOLS_ONE_MODALITY = (96, 64)


def slice_settings(batch: int, height: int = 480, width: int = 640,
                   T1: int = 8, modalities: int = 2) -> dict:
    """BatchedMatcher keyword arguments of the production pooled path at
    batch B (the reference bench's headline): top_k 128, fine_g 4,
    pool_coarse 56 B, pool_fine 36 B, sel_row_cap 128, group bound 16.

    A bank of one modality (the Ensenso's ColorGradient bank) gets pools
    of POOLS_ONE_MODALITY slots a frame: with one modality the bounds
    prune less, and its coarse survivors overflow 56 B on every batch.

    The group tier's pool is every level-1 position of the batch
    (B * Hc * Wc), not the bench's 2 * pool_coarse: on RGB-D scenes whose
    background is a flat depth plane, the group-max bound over 16 views
    clears the threshold almost everywhere (every position of every frame
    on the committed scenes), so a 2 * pool_coarse pool overflows on every
    batch and the exhaustive fallback always runs."""
    P = (height // 2 // T1) * (width // 2 // T1)
    coarse, fine = POOLS_ONE_MODALITY if modalities == 1 else (56, 36)
    return dict(top_k=128, prune=True, prune_mode="pooled", fine_g=4,
                pool_coarse=coarse * batch, pool_fine=fine * batch, sel_row_cap=128,
                group_bound=16, pool_group=batch * P)


def _frames(rgbs, depths_mm, use_depth: bool, device, conditioning=None):
    """The batch as tensors on `device`; depth is required by a
    DepthNormal bank.  With a `conditioning` (an api.service.
    FrameConditioning) the raw frames are copied as they are and
    conditioned on `device`."""
    if use_depth and depths_mm is None:
        raise ValueError(
            "this bank uses the DepthNormal modality: match_batch "
            "requires depths_mm (B, H, W) in millimetres"
        )
    if conditioning is not None and depths_mm is not None:
        raise ValueError("a conditioned batch is colour alone: no depths_mm")
    with tracing.span("lpe.entry.h2d"):
        rgbs = _to_device(rgbs, device)
        if depths_mm is not None:
            depths_mm = _to_device(depths_mm, device)
    if conditioning is not None:
        with tracing.span("lpe.entry.condition"):
            c = conditioning
            rgbs = condition_frames(rgbs, c.bias_x, c.crop_w, c.crop_h, c.blur)
        tracing.count("condition.frames", rgbs.shape[0])
    return rgbs, depths_mm


def _to_device(a, device) -> torch.Tensor:
    """`a` as a tensor on `device`.  A copy from host memory to a card
    returns once the copy is done: a host sync, counted as one."""
    if torch.device(device).type == "cuda" and not (isinstance(a, torch.Tensor) and a.is_cuda):
        tracing.count("sync")
    return torch.as_tensor(a, device=device)


PRUNE_MODES = ("positions", "two_axis", "pooled")


class BatchedMatcher:
    """`prune=False` (the default) scores every position of every template
    with ONE exhaustive call of the exact scorer over the batch, selects
    each frame's top_k and walks all of them.  `prune=True` runs the exact
    scorer only where the cell-max upper bound reaches the selection
    threshold (`threshold - 5`), in one of three modes.

    `prune_mode="positions"` (the default with `prune=True`) keeps at most
    `prune_pos_cap` survivor positions per frame.  `fine_g` adds the second
    stage: a g x g subcell max bound re-tested at the coarse survivors,
    compacted to `fine_pos_cap` positions (None -> half of
    `prune_pos_cap`) before the exact scores; a `fine_g` that does not
    divide T1, or None, disables the stage.  A frame past `fine_pos_cap`
    sends the batch through the coarse survivor set, a frame past
    `prune_pos_cap` through the exhaustive scores, so results are
    unconditionally exact.  `self.last_prune` (a PrunePlan) and
    `self.last_fine` (a FinePlan; None without the stage) report the most
    recent batch's survivor counts and overflow flags.

    `prune_mode="two_axis"` compacts both axes: at most `prune_cap`
    templates (the batch union) x `prune_pos_cap` positions per frame.  It
    has NO fallback: over capacity it keeps the highest-bound entries and
    `self.last_prune.overflow` says so.

    `prune_mode="pooled"` (the production mode) runs ONE batch-shared
    frame-major survivor pool per stage; `pool_coarse` / `pool_fine` size
    the two pools (None -> 64/32 slots per batch frame), `sel_row_cap`
    bounds the per-frame select range, `group_bound` turns on the
    group-max pre-bound with a `pool_group`-slot pool (None -> 2 x
    pool_coarse).  Any overflow runs the exhaustive scores.  `self.last_pool`
    (a PooledStats) reports true survivor totals and any fallback of the
    most recent batch, and `self.last_n_valid` its per-frame count of valid
    candidates; the walk skips the slots past it.

    `conditioning` (an api.service.FrameConditioning; None: frames come
    ready) takes raw camera frames, (B, H, W) mono or (B, H, W, 3) u8 of
    any size the crop fits: one copy to the device as they are, then the
    service's condition_frame on the device (ops.features.condition_frames)
    before the preprocess.  Such frames carry no depth, so the bank must
    be colour-only.

    `device` places the bank operands and the computation.  `plain=True`
    runs the plain PyTorch versions of K1, K2, DN, XS, TK and K3 even on the
    card — the path the kernels are checked against."""

    def __init__(self, detector, class_id: str, threshold: float, batch: int,
                 top_k: int = 256, prune: bool = False, prune_cap: int = 1024,
                 prune_pos_cap: int = 256, prune_mode: str = "positions",
                 fine_g: int | None = 4, fine_pos_cap: int | None = None,
                 pool_coarse: int | None = None, pool_fine: int | None = None,
                 sel_row_cap: int = 128, group_bound: int | None = None,
                 pool_group: int | None = None, device=DEFAULT_DEVICE,
                 plain: bool = False, conditioning=None):
        if prune_mode not in PRUNE_MODES:
            raise ValueError(f"prune_mode={prune_mode!r}: one of {PRUNE_MODES}")
        p = detector.params
        if conditioning is not None and p.use_depth_normal:
            raise ValueError("conditioned frames carry no depth: the bank must not use "
                             "the DepthNormal modality")
        self.conditioning = conditioning
        bank = detector.bank(class_id)
        self.device = resolve_device(device)
        self.T0, self.T1 = p.t_pyramid
        self.prune = prune
        self.prune_mode = prune_mode
        self.threshold = threshold
        self.top_k = top_k
        self.batch = batch
        self.Kc1 = bank.max_cell_extent(1)
        self.E0 = bank.extent(0)
        self.feats1 = bank.merged_features(1).to(self.device)
        self.feats0 = bank.merged_features(0).to(self.device)
        self.use_depth = p.use_depth_normal
        self.weak = p.color.weak_threshold
        self.plain = plain
        self.prune_cap = min(prune_cap, int(self.feats1.oris.shape[0]))
        self.prune_pos_cap = prune_pos_cap
        self.fine_g = fine_g if self.T1 % (fine_g or 1) == 0 else None
        self.fine_pos_cap = M._default_cap(fine_pos_cap, prune_pos_cap,
                                           "fine_pos_cap")
        self.pool_coarse = pool_coarse if pool_coarse is not None else 64 * batch
        self.pool_fine = pool_fine if pool_fine is not None else 32 * batch
        self.sel_row_cap = sel_row_cap
        self.group_bound = group_bound
        self.pool_group = pool_group if pool_group is not None \
            else 2 * self.pool_coarse
        self._vpos: dict[tuple[int, int], torch.Tensor] = {}
        self.last_prune: M.PrunePlan | None = None
        self.last_fine: M.FinePlan | None = None
        self.last_pool: M.PooledStats | None = None
        self.last_n_valid: torch.Tensor | None = None
        if prune_mode == "pooled" and not self.fine_g:
            raise ValueError("prune_mode='pooled' requires a fine_g that "
                             f"divides T1={self.T1}")
        if prune_mode == "pooled" and not prune:
            raise ValueError("prune_mode='pooled' requires prune=True")
        C = 8 * bank.num_modalities
        fine = prune and prune_mode != "two_axis" and self.fine_g
        group = prune and prune_mode == "pooled" and group_bound
        self.weights = M.build_bank_weights(
            self.feats1, C, self.T1, self.Kc1, self.fine_g if fine else None,
            group_bound if group else None)

    def _vpos_flat(self, Hc: int, Wc: int) -> torch.Tensor:
        if (Hc, Wc) not in self._vpos:
            self._vpos[(Hc, Wc)] = M.position_validity_flat(
                self.feats1.size, self.T1, Hc, Wc)
        return self._vpos[(Hc, Wc)]

    def candidates(self, rgbs, depths_mm=None):
        """Preprocess + exact candidate selection: (R0, CoarseMatches (B,
        top_k), n_valid (B,) in pooled mode, else None) — the first half
        of match_batch."""
        rgbs, depths_mm = _frames(rgbs, depths_mm, self.use_depth, self.device,
                                  self.conditioning)
        T1 = self.T1
        R0, R1 = M.preprocess_frames_batched(
            rgbs, depths_mm, T0=self.T0, T1=T1, use_depth=self.use_depth,
            weak_threshold=self.weak, plain=self.plain)
        Hc, Wc = R1.shape[2] // T1, R1.shape[3] // T1
        vpos = self._vpos_flat(Hc, Wc)
        thr = self.threshold - 5.0  # the coarse gate, 5 below the reported one
        w = self.weights
        count = self.feats1.count
        if not self.prune:
            raw = M.coarse_scores_gemm_flat_batched(R1, w.exact, T1, self.Kc1, self.plain)
            cands = M.select_candidates_flat(raw, count, vpos, thr, self.top_k, Wc,
                                             self.plain)
            return R0, cands, None
        if self.prune_mode == "positions":
            if self.fine_g:
                cands, self.last_prune, self.last_fine = \
                    M.match_coarse_pruned_fine_with_fallback(
                        R1, w.exact, w.W_cell, w.W_fine, count, vpos, thr, T1,
                        self.Kc1, self.fine_g, self.prune_pos_cap,
                        self.fine_pos_cap, self.top_k, Wc, self.plain)
            else:
                cands, self.last_prune = M.match_coarse_pruned_with_fallback(
                    R1, w.exact, w.W_cell, count, vpos, thr, T1, self.Kc1,
                    self.prune_pos_cap, self.top_k, Wc, self.plain)
                self.last_fine = None
            return R0, cands, None
        if self.prune_mode == "two_axis":
            pr = M.prune_plan_batched(R1, w.W_cell, count, vpos, thr, T1,
                                      self.Kc1, self.prune_cap, self.prune_pos_cap)
            self.last_prune = pr
            raw_sub = M.coarse_scores_gemm_flat_batched_sub2(
                R1, w.exact, pr.t_idx, pr.p_idx, T1, self.Kc1, self.plain)
            cands = M.select_candidates_flat_sub2(
                raw_sub, count, vpos, pr.t_idx, pr.t_keep, pr.p_idx, pr.p_keep,
                thr, self.top_k, Wc)
            return R0, cands, None
        group = {}
        if w.W_group is not None:
            group = dict(W_group=w.W_group, group_counts=w.group_counts,
                         pool0=self.pool_group, group=self.group_bound)
        cands, n_valid, stats = M.match_pooled_fine_with_fallback(
            R1, w.exact, w.W_cell, w.W_fine, count, vpos, thr, T1,
            self.Kc1, self.fine_g, self.pool_coarse, self.pool_fine, self.top_k,
            Wc, r_cap=self.sel_row_cap, **group, plain=self.plain,
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
        (B, top_k) tensors on the matcher's device (mask by .valid); with a
        `conditioning`, raw (B, H, W_in) mono or (B, H, W_in, 3) frames."""
        with tracing.span("lpe.batch"):
            return self.refine(*self.candidates(rgbs, depths_mm))

    def match_batch_list(self, rgbs, depths_mm=None) -> list[M.Matches]:
        """match_batch, unstacked to per-frame Matches records."""
        m = self.match_batch(rgbs, depths_mm)
        return [M.Matches(*(a[b] for a in m)) for b in range(m.valid.shape[0])]


class MultiClassBatchedMatcher:
    """Several object classes per frame batch through ONE pipeline: the
    classes' template axes are concatenated (ops.match.concat_level_
    features), so one preprocess, one pruned pass at min(thresholds), one
    call of the exact scorer and one walk over the merged, re-sorted
    candidates serve every class; only the select runs per class, over the
    class's own columns at its threshold - 5, and each class's walked
    matches are split out in one top-k and re-gated at its own threshold.

    `prune_mode="positions"` (the default) is BatchedMatcher's per-frame
    cap mode over the merged bank (ops.match.match_coarse_pruned_
    multiclass): `prune_pos_cap`, `fine_g` and `fine_pos_cap` as there,
    the same exact fallbacks, `self.last_prune` its PrunePlan.
    `prune_mode="pooled"` is the batch-shared pool (ops.match.match_pooled_
    multiclass; pools as in BatchedMatcher, no group tier, as in the
    reference) with `self.last_pool` its PooledStats.  `device` and `plain`
    as in BatchedMatcher."""

    def __init__(self, detector, class_ids: list[str], thresholds, batch: int,
                 top_k: int = 256, prune_pos_cap: int = 256,
                 fine_g: int | None = 4, fine_pos_cap: int | None = None,
                 prune_mode: str = "positions",
                 pool_coarse: int | None = None, pool_fine: int | None = None,
                 sel_row_cap: int = 128, device=DEFAULT_DEVICE, plain: bool = False):
        if prune_mode not in ("positions", "pooled"):
            raise ValueError(f"prune_mode={prune_mode!r}: 'positions' or 'pooled'")
        if isinstance(thresholds, (int, float)):
            thresholds = [float(thresholds)] * len(class_ids)
        if len(thresholds) != len(class_ids):
            raise ValueError("need one threshold per class")
        p = detector.params
        self.device = resolve_device(device)
        self.class_ids = list(class_ids)
        self.thresholds = [float(t) for t in thresholds]
        self.T0, self.T1 = p.t_pyramid
        self.fine_g = fine_g if self.T1 % (fine_g or 1) == 0 else None
        if prune_mode == "pooled" and not self.fine_g:
            raise ValueError("prune_mode='pooled' requires a fine_g that "
                             f"divides T1={self.T1}")
        self.top_k = top_k
        self.batch = batch
        self.use_depth = p.use_depth_normal
        self.weak = p.color.weak_threshold
        self.prune_mode = prune_mode
        self.prune_pos_cap = prune_pos_cap
        self.fine_pos_cap = M._default_cap(fine_pos_cap, prune_pos_cap,
                                           "fine_pos_cap")
        self.pool_coarse = pool_coarse if pool_coarse is not None else 64 * batch
        self.pool_fine = pool_fine if pool_fine is not None else 32 * batch
        self.sel_row_cap = sel_row_cap
        self.plain = plain
        self.last_pool: M.PooledStats | None = None
        self.last_prune: M.PrunePlan | None = None

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
        self.weights = M.build_bank_weights(self.feats1, C, self.T1, self.Kc1,
                                            self.fine_g)
        # The classes' report gates and column ranges, on the device once: a
        # host number copied per batch would wait for the stream each time.
        self._gates = torch.tensor(self.thresholds, dtype=torch.float32, device=self.device)
        self._bounds = M.class_bounds(self.slices, self.device)
        self._columns: dict[tuple[int, int], tuple] = {}

    def _class_columns(self, Hc: int, Wc: int) -> tuple:
        """(vpos (P, N), [ClassColumns] per class: its columns, their
        validity (P, hi - lo), its select threshold) of an Hc x Wc level-1
        grid, built at its first batch."""
        if (Hc, Wc) not in self._columns:
            vpos = M.position_validity_flat(self.feats1.size, self.T1, Hc, Wc)
            sel_thrs = [t - 5.0 for t in self.thresholds]
            self._columns[(Hc, Wc)] = (vpos, M._class_columns(vpos, self.slices, sel_thrs))
        return self._columns[(Hc, Wc)]

    def candidates(self, rgbs, depths_mm=None):
        """Preprocess + the pruned pass over the merged bank: (R0, [CoarseMatches
        (B, top_k) per class]) — the first half of match_batch."""
        rgbs, depths_mm = _frames(rgbs, depths_mm, self.use_depth, self.device)
        T1 = self.T1
        R0, R1 = M.preprocess_frames_batched(
            rgbs, depths_mm, T0=self.T0, T1=T1, use_depth=self.use_depth,
            weak_threshold=self.weak, plain=self.plain)
        Hc, Wc = R1.shape[2] // T1, R1.shape[3] // T1
        vpos, classes = self._class_columns(Hc, Wc)
        w = self.weights
        sel_thrs = [c.threshold for c in classes]
        tracing.count("multiclass.batch")
        tracing.count("multiclass.classes", len(classes))
        if self.prune_mode == "pooled":
            cands, _, self.last_pool = M.match_pooled_multiclass(
                R1, w.exact, w.W_cell, w.W_fine, self.feats1.count, vpos,
                self.slices, sel_thrs, T1, self.Kc1, self.fine_g,
                self.pool_coarse, self.pool_fine, self.top_k, Wc,
                r_cap=self.sel_row_cap, classes=classes, plain=self.plain,
            )
        else:
            cands, self.last_prune = M.match_coarse_pruned_multiclass(
                R1, w.exact, w.W_cell, w.W_fine, self.feats1.count, vpos,
                self.slices, sel_thrs, T1, self.Kc1, self.prune_pos_cap,
                self.top_k, Wc, g=self.fine_g, m2_cap=self.fine_pos_cap,
                classes=classes, plain=self.plain,
            )
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
        with tracing.span("lpe.split"):
            st = M.split_matches_stacked(m, self._bounds, self.top_k)
            st = st._replace(valid=st.valid & (st.similarity >= self._gates[:, None]))
            return {cid: M.Matches(*(a[:, i] for a in st))
                    for i, cid in enumerate(self.class_ids)}

    def match_batch(self, rgbs, depths_mm=None) -> dict[str, M.Matches]:
        """(B, H, W, 3) uint8 [+ (B, H, W) mm] -> {class_id: Matches} with
        (B, top_k) tensors, template ids re-based per class."""
        with tracing.span("lpe.batch"):
            return self.refine(*self.candidates(rgbs, depths_mm))


class PipelinedRunner:
    """Keep up to `depth` submitted steps in flight on `device`.

    submit() runs fn and records a CUDA event after it on the current
    stream, then returns without waiting for the device; collect() waits
    on the OLDEST step's event only.  Results come out in submission
    order, and submitting past `depth` waits on (and returns) the oldest
    result, which bounds the device memory in flight.  A step that reads
    a flag on the host (the pooled matcher's `.item()`s, ICP's per-
    iteration check, detect's copies to the host) has run most of its
    device work by the time fn returns, so what is left to overlap is the
    tail after its last host read.  On `device="cpu"` fn's results are
    ready when it returns."""

    def __init__(self, fn, depth: int = 2, device=DEFAULT_DEVICE):
        if depth < 1:
            raise ValueError(f"depth must be >= 1 (got {depth})")
        self.fn = fn
        self.depth = depth
        self.device = resolve_device(device)
        self._q: deque = deque()

    def __len__(self) -> int:
        return len(self._q)

    def submit(self, *args, **kwargs):
        """Dispatch one step; returns the oldest completed result when the
        pipeline was full, else None.  Dispatch comes before the wait: if
        fn raises, nothing already in flight is lost and the queue is
        unchanged (one caller-side stamp per submitted step stays paired)."""
        out = self.fn(*args, **kwargs)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        self._q.append((out, event))
        if len(self._q) > self.depth:
            return self.collect()
        return None

    def collect(self):
        """Wait for and return the oldest in-flight result."""
        if not self._q:
            raise RuntimeError("collect() with nothing in flight")
        out, event = self._q.popleft()
        if event is not None:
            event.synchronize()
        return out

    def drain(self) -> list:
        """Collect every remaining in-flight result, oldest first."""
        out = []
        while self._q:
            out.append(self.collect())
        return out


def look_at_point(cloud: torch.Tensor, rect_xywh, cap: int = 256) -> torch.Tensor:
    """The 3-D gaze target at a detection's bbox centre (the carmine
    node's get_look_at_point): the cloud point there, or where that is not
    finite, the finite point of the bbox nearest the centroid of its
    first `cap` finite points."""
    H, W = cloud.shape[:2]
    x, y, w, h = (int(v) for v in rect_xywh)
    center = cloud[min(max(y + h // 2, 0), H - 1), min(max(x + w // 2, 0), W - 1)]
    pts, valid = pcu.extract_rect_points(cloud, (x, y, w, h), cap)
    fallback = pcu.nearest_point(pts, valid, pcu.masked_centroid(pts, valid))
    return torch.where(torch.isfinite(center).all(), center, fallback)


def template_refinement(pose: torch.Tensor, cloud: torch.Tensor, rect_xywh,
                        triangles: torch.Tensor, K_render: torch.Tensor,
                        render_wh: tuple[int, int], model_cap: int = 1024,
                        scene_cap: int = 1024, bias_x: int = 0,
                        viewport: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """One re-render + re-ICP round at an estimated pose (4, 4) (the
    carmine node's templateRefinement): returns (refined pose, ICP
    fitness).  The render (K4 on the card) puts the object on the optical
    axis at |t|; `viewport` is its centred window (0 = the full render
    size).  The scene set is the render's mask placed at the detection's
    rect, dilated by 2 px, over the organized cloud (H, W, 3)."""
    from .cascade import _compact_points, _transplanted_scene_mask, dilate_mask
    from .renderer import render as render_fn

    rw, rh = render_wh
    if viewport and viewport < min(rw, rh):
        K_render = K_render.clone()
        K_render[0, 2] = K_render[1, 2] = viewport / 2.0
        rw = rh = viewport
    R, t = pose[:3, :3], pose[:3, 3]
    T_bank = R.transpose(0, 1) @ t  # render's X_cam = R (X + T)
    out = render_fn(triangles, R.to(torch.float32), T_bank.to(torch.float32), K_render, rw, rh)
    mcloud = pcu.depth_to_cloud(pcu.true_div(out.depth_mm, 1000.0), K_render)
    msel = (out.mask > 0) & torch.isfinite(mcloud).all(dim=-1)
    model_pts, model_valid = _compact_points(mcloud.reshape(1, -1, 3), msel.reshape(1, -1),
                                             model_cap)
    # Recentre the rendered model at the pose translation.
    model_pts = model_pts - pcu.masked_centroid(model_pts, model_valid)[:, None, :] + t
    H, W = cloud.shape[:2]
    x, y = int(rect_xywh[0]), int(rect_xywh[1])
    smask = dilate_mask(_transplanted_scene_mask(out.mask, out.rect, x + bias_x, y, H, W), 2)
    ssel = smask & torch.isfinite(cloud).all(dim=-1)
    scene_pts, scene_valid = _compact_points(cloud.reshape(1, -1, 3), ssel.reshape(1, -1),
                                             scene_cap)
    res = icp_two_stage(model_pts, model_valid, scene_pts, scene_valid)
    return res.transform[0] @ pose, res.fitness[0]
