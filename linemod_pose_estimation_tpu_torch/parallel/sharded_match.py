"""Multi-device template matching on ``torch.distributed``: the port of
``linemod_pose_estimation_tpu/parallel/sharded_match.py``.

The reference runs each step as one ``shard_map`` body over a JAX mesh;
here every rank is a process that calls the same step on its own shard
(the body's local view) and the collectives are ``torch.distributed``
calls on the mesh's process groups:

- make_sharded_coarse_matcher: coarse scoring only, on the gather scan
  (ops.match.coarse_scores), the bank sharded over "bank";
- make_sharded_detect_step: the production step.  Each rank preprocesses
  its frames (K1, K2), scores them against its bank shard in one of the
  four modes of BatchedMatcher (pooled, positions, two_axis, exhaustive),
  walks its own candidates (K3), re-bases the template ids, and the
  shards' Matches are all-gathered over "bank" into a global top-k;
- make_row_sharded_matcher: the frame's rows sharded over one mesh dim,
  the bank replicated, halos pulled from the neighbouring stripes;
- make_ring_bank / make_ring_detect_step: frames data-parallel over the
  ring, bank shards rotating one hop a step.

Transport.  The backend decides it: under ``nccl`` the tensors stay on the
card; under ``gloo`` a CUDA payload of a point-to-point hop is staged
through host tensors, since gloo's send and receive read the device
pointer as host memory (on the H100's machine, torch 2.11, the process
aborts), while its all-gather and all-reduce take CUDA tensors and stage
them themselves.  No helper catches a failed collective.

Every collective sits outside the host branches of a step: the port's
pooled and positions paths read their overflow flags with ``.item()``,
and shards legitimately take different branches, so a collective inside
one would leave the ranks waiting on each other.

Two faults of the reference are fixed.  The sharded pooled step passes
the bank's group tier (``make_sharded_bank(group_bound=)``) to
match_pooled_fine_with_fallback, which the reference's step omits
(``sharded_match.py:570-574``); and the fine-width check reads the
channel count from the bank (``ShardedBank.C``) instead of deriving it
from ``use_depth`` (``:534``).  Neither changes a Match.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops import match as M
from ..utils.device import DEFAULT_DEVICE, resolve_device


def _local(x) -> torch.Tensor | None:
    """A step's input as this rank's tensor: a DTensor's local shard (what
    a shard_map body sees), or the tensor / array as it is."""
    from torch.distributed.tensor import DTensor

    if x is None:
        return None
    if isinstance(x, DTensor):
        return x.to_local()
    return torch.as_tensor(x)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def _staged(t: torch.Tensor, group) -> bool:
    """A point-to-point payload that goes through a host tensor: a CUDA
    tensor under gloo, which sends and receives host memory only."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _logged(log: dict | None, kind: str, t: torch.Tensor) -> None:
    if log is not None:
        log[kind] = log.get(kind, 0) + t.numel() * t.element_size()


def _group_ranks(mesh: DeviceMesh, dim: str) -> list[int]:
    """Group rank of each coordinate along `dim` in this rank's line of
    the mesh, read through the DeviceMesh (a group's rank order is not
    the mesh's coordinate order in general)."""
    g = mesh.get_group(dim)
    ax = mesh.mesh_dim_names.index(dim)
    coord = {}
    for r in range(g.size()):
        where = (mesh.mesh == dist.get_global_rank(g, r)).nonzero()[0]
        coord[int(where[ax])] = r
    return [coord[c] for c in range(g.size())]


def _all_gather(t: torch.Tensor, mesh: DeviceMesh, dim: str,
                log: dict | None = None) -> list[torch.Tensor]:
    """Every coordinate's `t` along `dim`, in coordinate order."""
    g = mesh.get_group(dim)
    src = t.contiguous()
    out = [torch.empty_like(src) for _ in range(g.size())]
    dist.all_gather(out, src, group=g)
    _logged(log, "all_gather", src)
    return [out[r] for r in _group_ranks(mesh, dim)]


def _all_reduce(t: torch.Tensor, op, log: dict | None = None) -> torch.Tensor:
    """`t` reduced over the whole mesh (the world group), in place."""
    dist.all_reduce(t, op=op)
    _logged(log, "all_reduce", t)
    return t


class _Pending:
    """Receives of a ppermute in flight; wait() returns them on the
    device of the tensors that were sent."""

    def __init__(self, works, bufs, device):
        self.works, self.bufs, self.device = works, bufs, device

    def wait(self) -> list[torch.Tensor]:
        for w in self.works:
            w.wait()
        return [b.to(self.device) for b in self.bufs]


def _ppermute_start(tensors, mesh: DeviceMesh, dim: str, shift: int,
                    log: dict | None = None) -> _Pending:
    """Start one ppermute hop along `dim`: every coordinate c sends
    `tensors` to c - shift and receives the same shapes from c + shift
    (mod n), all sends and receives in one batch_isend_irecv so that no
    rank blocks its neighbour.  Returns the receives in flight."""
    g = mesh.get_group(dim)
    n = g.size()
    dev = tensors[0].device
    if shift % n == 0:
        return _Pending([], [t.clone() for t in tensors], dev)
    ranks = _group_ranks(mesh, dim)
    c = mesh.get_local_rank(dim)
    dst = dist.get_global_rank(g, ranks[(c - shift) % n])
    src = dist.get_global_rank(g, ranks[(c + shift) % n])
    ops, bufs = [], []
    for t in tensors:
        send = t.cpu() if _staged(t, g) else t.contiguous()
        recv = torch.empty_like(send)
        ops += [dist.P2POp(dist.isend, send, dst, g), dist.P2POp(dist.irecv, recv, src, g)]
        bufs.append(recv)
        _logged(log, "ppermute", send)
    return _Pending(dist.batch_isend_irecv(ops), bufs, dev)


def _packed(rec) -> torch.Tensor:
    """A (B, K) record's fields as int32 columns (B, K, F): floats by
    their bits, bools as 0/1 — one all-gather payload."""
    cols = [f.view(torch.int32) if f.dtype == torch.float32 else f.to(torch.int32)
            for f in rec]
    return torch.stack(cols, dim=-1)


def _merge_topk(rec, top_k: int, threshold: float, mesh: DeviceMesh, dim: str,
                log: dict | None = None):
    """All-gather per-shard (B, K) records (Matches or CoarseMatches:
    similarity and valid are the last two fields) along `dim`, laid out
    shard-major as the reference's all_gather(axis=1), and keep the
    global top-k: ties to the lower flat index, i.e. the lower shard;
    valid = gathered valid & (value >= threshold)."""
    B, K = rec.valid.shape
    parts = _all_gather(_packed(rec), mesh, dim, log)
    allr = torch.stack(parts, dim=1).reshape(B, len(parts) * K, len(rec))
    cols = [allr[..., i].contiguous() for i in range(len(rec))]
    sims = cols[-2].view(torch.float32)
    valid = cols[-1].bool()
    vals, idx = M._topk_first_index(torch.where(valid, sims, -1.0), top_k)
    take = lambda a: torch.gather(a, 1, idx)
    thr = torch.tensor(threshold, dtype=torch.float32, device=vals.device)
    return type(rec)(*(take(a) for a in cols[:-2]), vals, take(valid) & (vals >= thr))


def _mesh_size(mesh: DeviceMesh, dim: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(dim)]


# ---------------------------------------------------------------------------
# Banks
# ---------------------------------------------------------------------------


def pad_bank_features(feats: M.LevelFeatures, shards: int) -> M.LevelFeatures:
    """Pad the template axis to a multiple of `shards`; the padded
    templates are dead: live=False, count=0, and a size of 10**6 so that
    no position validates."""
    N = feats.oris.shape[0]
    pad = (-N) % shards
    if pad == 0:
        return feats
    z = lambda a, fill=0: torch.cat(
        [a, torch.full((pad,) + tuple(a.shape[1:]), fill, dtype=a.dtype, device=a.device)])
    return M.LevelFeatures(
        offsets=z(feats.offsets), oris=z(feats.oris), live=z(feats.live, False),
        count=z(feats.count), size=z(feats.size, 10**6),
    )


def _shard_rows(feats: M.LevelFeatures, shard: int, n_shards: int, device) -> M.LevelFeatures:
    n_local = feats.oris.shape[0] // n_shards
    sl = slice(shard * n_local, (shard + 1) * n_local)
    return M.LevelFeatures(*(a[sl].to(device) for a in feats))


class ShardedBank(NamedTuple):
    """This rank's shard of a bank for the sharded detect step: its
    templates' weights (the exact scorer's, the cell bound's, the fine
    bound's when `fine_g` is set, the group tier's when `group` is set),
    both levels' features, and the bank's channel count C
    (8 per modality), fine_g and group size."""

    weights: M.BankWeights
    feats1: M.LevelFeatures
    feats0: M.LevelFeatures
    C: int
    fine_g: int | None
    group: int | None


def _effective_fine_g(T1: int, fine_g: int | None) -> int | None:
    """The fine stage needs g | T1; None (or an indivisible g) disables
    it.  make_sharded_bank and the step both route through here."""
    return fine_g if fine_g and T1 % fine_g == 0 else None


def make_sharded_bank(
    mesh: DeviceMesh, feats1: M.LevelFeatures, feats0: M.LevelFeatures, C: int,
    T1: int, Kc1: int, fine_g: int | None = 4, group_bound: int | None = None,
    device=DEFAULT_DEVICE,
) -> ShardedBank:
    """Pad the whole bank's features to a multiple of the "bank" dim, take
    this rank's rows [r * n_local, (r + 1) * n_local) and build their
    weights on `device`.  `group_bound` builds the pooled step's group
    tier over the shard."""
    n_bank = _mesh_size(mesh, "bank")
    r = mesh.get_local_rank("bank")
    dev = resolve_device(device)
    f1 = _shard_rows(pad_bank_features(feats1, n_bank), r, n_bank, dev)
    f0 = _shard_rows(pad_bank_features(feats0, n_bank), r, n_bank, dev)
    g = _effective_fine_g(T1, fine_g)
    return ShardedBank(M.build_bank_weights(f1, C, T1, Kc1, g, group_bound), f1, f0,
                       C, g, group_bound)


class RingBank(NamedTuple):
    """This rank's starting shard of a ring bank: the exact scorer's
    weights and both levels' features (the rotating payload); the shard's
    id is the rank's ring coordinate."""

    W1: M.ExactWeights
    feats1: M.LevelFeatures
    feats0: M.LevelFeatures


def make_ring_bank(
    mesh: DeviceMesh, axis: str, feats1: M.LevelFeatures, feats0: M.LevelFeatures,
    C: int, T1: int, Kc1: int, device=DEFAULT_DEVICE,
) -> RingBank:
    """Pad the whole bank's features to a multiple of the `axis` dim and
    build this rank's starting shard, rows [r * n_local, (r + 1) * n_local)
    for ring coordinate r, on `device`."""
    n = _mesh_size(mesh, axis)
    r = mesh.get_local_rank(axis)
    dev = resolve_device(device)
    f1 = _shard_rows(pad_bank_features(feats1, n), r, n, dev)
    f0 = _shard_rows(pad_bank_features(feats0, n), r, n, dev)
    return RingBank(M.exact_weights(f1, C, T1, Kc1), f1, f0)


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------


def make_sharded_coarse_matcher(mesh: DeviceMesh, T: int, max_cell_extent: int,
                                top_k: int, threshold: float):
    """Coarse-only matcher on the gather scan: fn(R_local (B, C, H, W),
    feats_local (this rank's "bank" shard)) -> CoarseMatches (B, top_k),
    the global top-k over every shard (equal on the ranks of a "data"
    row)."""

    def fn(R_local, feats_local: M.LevelFeatures) -> M.CoarseMatches:
        shard = mesh.get_local_rank("bank")
        n_local = feats_local.oris.shape[0]
        out = []
        for R in _local(R_local):
            raw = M.coarse_scores(R, feats_local, T, max_cell_extent)
            Hc, Wc = raw.shape[1:]
            vpos = M.position_validity(feats_local.size, T, Hc, Wc)
            c = M.select_candidates(raw, feats_local.count, vpos, threshold, top_k)
            out.append(c._replace(template_id=c.template_id + shard * n_local))
        cand = M.CoarseMatches(*(torch.stack(a) for a in zip(*out)))
        return _merge_topk(cand, top_k, threshold, mesh, "bank")

    return fn


class ShardedDetectStep:
    """The full multi-device detect step over a raw frame batch:
    step(rgbs, depths, bank) -> (Matches (B_local, top_k), metrics)
    (make_sharded_detect_step, the reference's name, builds one).

    Per rank, the single-device matcher's stages (models/serving.
    BatchedMatcher) over its frames and its bank shard: preprocess (K1 x2,
    K2 x4), then `prune_mode` "pooled" (the batch-shared pool; pools of
    `pool_coarse` / `pool_fine` slots, None -> 64 / 32 per local frame,
    and with the bank's group tier a group pool of every position of the
    local batch, as serving.slice_settings sizes it), "positions"
    (per-frame caps, with the fine stage when `fine_g` divides T1), or
    "two_axis"; `prune=False` the exhaustive scores.  The walk (K3) refines
    this shard's candidates, the ids are re-based by shard * n_local, and
    the shards' Matches merge into a global top-k over "bank".
    `plain=True` runs the plain versions of K1, K2, DN, XS, TK and K3.

    After a call, `last_pool` and `last_n_valid` (pooled), `last_prune` /
    `last_fine` (positions, two_axis) hold this rank's plans, and
    `last_collectives` the bytes this rank put into each kind of
    collective."""

    def __init__(self, mesh: DeviceMesh, T1: int, Kc1: int, top_k: int,
                 threshold: float, T0: int = 5, E0: int = 96, use_depth: bool = False,
                 coarse_margin: float = 5.0, weak_threshold: float = 10.0,
                 prune: bool = True, prune_cap: int = 1024, prune_pos_cap: int = 256,
                 prune_mode: str = "positions", fine_g: int | None = 4,
                 fine_pos_cap: int | None = None, pool_coarse: int | None = None,
                 pool_fine: int | None = None, sel_row_cap: int = 128,
                 plain: bool = False):
        self.mesh = mesh
        self.T0, self.T1, self.Kc1, self.E0 = T0, T1, Kc1, E0
        self.top_k, self.threshold = top_k, threshold
        self.use_depth, self.weak = use_depth, weak_threshold
        self.sel_thr = max(threshold - coarse_margin, 0.0)
        self.prune, self.prune_mode = prune, prune_mode
        self.prune_cap, self.prune_pos_cap = prune_cap, prune_pos_cap
        self.fine_g = _effective_fine_g(T1, fine_g)
        self.m2_cap = M._default_cap(fine_pos_cap, prune_pos_cap, "fine_pos_cap")
        self.pool_coarse, self.pool_fine = pool_coarse, pool_fine
        self.sel_row_cap = sel_row_cap
        self.plain = plain
        self.last_pool = self.last_prune = self.last_fine = self.last_n_valid = None
        self.last_collectives: dict[str, int] = {}

    def _check_fine_width(self, bank: ShardedBank) -> None:
        """A bank built with another g (or none) fails here, before any
        work: the expected width comes from the bank's own C."""
        g = self.fine_g
        exp = (self.Kc1 * self.T1 // g) ** 2 * bank.C
        got = 0 if bank.weights.W_fine is None else bank.weights.W_fine.nk.shape[1]
        if got != exp:
            raise ValueError(
                f"bank W_fine has {got} columns but this step's fine_g={g} needs "
                f"{exp} (= (Kc1*T1/g)^2 * C with Kc1={self.Kc1}, T1={self.T1}, "
                f"the bank's C={bank.C}, the bank's fine_g={bank.fine_g}): build "
                "the bank and the step with the SAME fine_g (make_sharded_bank("
                "fine_g=...), or fine_g=None on both to disable the fine stage)")

    def _candidates(self, R1, bank: ShardedBank, vpos, Wc):
        """This shard's (CoarseMatches, n_valid or None, fallback flag);
        host branches only, no collective."""
        w, count = bank.weights, bank.feats1.count
        T1, Kc1, thr, k = self.T1, self.Kc1, self.sel_thr, self.top_k
        false = torch.zeros((), dtype=torch.bool, device=R1.device)
        if self.prune and self.prune_mode == "pooled":
            B = R1.shape[0]
            p1 = self.pool_coarse if self.pool_coarse is not None else 64 * B
            p2 = self.pool_fine if self.pool_fine is not None else 32 * B
            group = {}
            if w.W_group is not None:
                group = dict(W_group=w.W_group, group_counts=w.group_counts,
                             pool0=B * R1.shape[2] // T1 * Wc, group=bank.group)
            cand, nv, self.last_pool = M.match_pooled_fine_with_fallback(
                R1, w.exact, w.W_cell, w.W_fine, count, vpos, thr, T1, Kc1,
                self.fine_g, p1, p2, k, Wc, r_cap=self.sel_row_cap, **group,
                plain=self.plain)
            return cand, nv, self.last_pool.fallback
        if self.prune and self.prune_mode == "positions" and self.fine_g:
            cand, self.last_prune, self.last_fine = M.match_coarse_pruned_fine_with_fallback(
                R1, w.exact, w.W_cell, w.W_fine, count, vpos, thr, T1, Kc1,
                self.fine_g, self.prune_pos_cap, self.m2_cap, k, Wc, self.plain)
            return cand, None, self.last_prune.overflow | self.last_fine.overflow
        if self.prune and self.prune_mode == "positions":
            cand, self.last_prune = M.match_coarse_pruned_with_fallback(
                R1, w.exact, w.W_cell, count, vpos, thr, T1, Kc1,
                self.prune_pos_cap, k, Wc, self.plain)
            return cand, None, self.last_prune.overflow
        if self.prune:
            n_local = bank.feats1.oris.shape[0]
            pr = self.last_prune = M.prune_plan_batched(
                R1, w.W_cell, count, vpos, thr, T1, Kc1,
                min(self.prune_cap, n_local), self.prune_pos_cap)
            raw = M.coarse_scores_gemm_flat_batched_sub2(R1, w.exact, pr.t_idx,
                                                         pr.p_idx, T1, Kc1, self.plain)
            cand = M.select_candidates_flat_sub2(raw, count, vpos, pr.t_idx, pr.t_keep,
                                                 pr.p_idx, pr.p_keep, thr, k, Wc)
            return cand, None, pr.overflow
        raw = M.coarse_scores_gemm_flat_batched(R1, w.exact, T1, Kc1, self.plain)
        cand = M.select_candidates_flat(raw, count, vpos, thr, k, Wc, self.plain)
        return cand, None, false

    def __call__(self, rgbs, depths, bank: ShardedBank):
        """rgbs (B, H, W, 3) u8 and depths (B, H, W) f32 or None — this
        rank's frames, or DTensors over the mesh (put_global_batch) — and
        this rank's ShardedBank -> (Matches (B, top_k), metrics): the
        global top-k over every shard, and num_matches (valid matches of
        the whole batch), best_similarity (-1 when none) and
        prune_fallback_shards (ranks whose shard took an exact
        fallback), each reduced over the whole mesh."""
        if self.prune and self.prune_mode == "pooled" and not self.fine_g:
            raise ValueError("prune_mode='pooled' requires fine_g")
        if self.prune and self.prune_mode in ("pooled", "positions") and self.fine_g:
            self._check_fine_width(bank)
        dev = bank.feats1.count.device
        rgbs = _local(rgbs).to(dev)
        depths = _local(depths)
        depths = None if depths is None else depths.to(dev)
        R0, R1 = M.preprocess_frames_batched(
            rgbs, depths, T0=self.T0, T1=self.T1, use_depth=self.use_depth,
            weak_threshold=self.weak, plain=self.plain)
        if R1.shape[1] != bank.C:
            raise ValueError(f"the bank has C={bank.C} channels but the frames give "
                             f"{R1.shape[1]} (use_depth={self.use_depth})")
        Hc, Wc = R1.shape[2] // self.T1, R1.shape[3] // self.T1
        vpos = M.position_validity_flat(bank.feats1.size, self.T1, Hc, Wc)
        cand, nv, fallback = self._candidates(R1, bank, vpos, Wc)
        self.last_n_valid = nv
        ref = M.refine_candidates_opencv_batched(
            R0, bank.feats0, cand, self.T1, self.threshold, E0=self.E0,
            fine_T=self.T0, n_valid=nv, plain=self.plain)
        shard = self.mesh.get_local_rank("bank")
        ref = ref._replace(template_id=ref.template_id + shard * bank.feats1.oris.shape[0])
        log = self.last_collectives = {}
        merged = _merge_topk(ref, self.top_k, self.threshold, self.mesh, "bank", log)
        sums = torch.stack([merged.valid.sum(), fallback.to(torch.int64)])
        _all_reduce(sums, dist.ReduceOp.SUM, log)
        best = torch.where(merged.valid, merged.similarity, -1.0).max()
        _all_reduce(best, dist.ReduceOp.MAX, log)
        n_bank = _mesh_size(self.mesh, "bank")
        metrics = {"num_matches": (sums[0] // n_bank).to(torch.int32),
                   "best_similarity": best,
                   "prune_fallback_shards": sums[1].to(torch.int32)}
        return merged, metrics


make_sharded_detect_step = ShardedDetectStep


class RowShardedMatcher:
    """One frame's rows sharded over mesh dim `axis` (the context-parallel
    analog), the bank replicated: fn(R1_loc (C, H1/n, W1), R0_loc (C,
    H0/n, W0), W1 (the bank's exact-scorer weights), feats1, feats0) ->
    Matches (top_k,), equal on every rank of the line
    (make_row_sharded_matcher, the reference's name, builds one).  Each
    rank scores the window positions anchored in its stripe, after
    pulling the halo rows its windows and walks reach from the
    neighbouring stripes (one ppermute per stripe-height hop), walks in
    global coordinates, and the stripes' Matches merge into a global
    top-k.  Level-0 stripes must be multiples of lcm(2*T1, T0).  `plain`
    and `last_collectives` as in ShardedDetectStep."""

    def __init__(self, mesh: DeviceMesh, axis: str, T1: int, Kc1: int, top_k: int,
                 threshold: float, T0: int = 5, E0: int = 96, coarse_margin: float = 5.0,
                 plain: bool = False):
        self.mesh, self.axis = mesh, axis
        self.n = _mesh_size(mesh, axis)
        self.T0, self.T1, self.Kc1, self.E0 = T0, T1, Kc1, E0
        self.top_k, self.threshold = top_k, threshold
        self.sel_thr = max(threshold - coarse_margin, 0.0)
        self.plain = plain
        self.halo1 = T1 * Kc1  # level-1 rows a window may read past its anchor
        # The walk's reach at level 0: up to 8*T0 rows above the clamped
        # anchor (E0 more when the bottom clamp pulls it up) and 15*T0 +
        # T0 - 1 + E0 below; rounded to multiples of T0 so the stride-T0
        # walk stays phase-aligned across the stripe seam.
        self.UP = -(-(8 * T0 + E0) // T0) * T0
        self.halo0 = -(-(16 * T0 + E0) // T0) * T0
        self.last_collectives: dict[str, int] = {}

    def _pull(self, X: torch.Tensor, rows: int, below: bool, idx: int, log) -> torch.Tensor:
        """The `rows` rows just below (or above) this stripe, hop by hop
        from the next (previous) stripes; zeros past the frame's bottom
        (top)."""
        parts, h, left = [], 1, rows
        while left > 0:
            take = min(left, X.shape[1])
            part = X[:, :take] if below else X[:, -take:]
            nb = _ppermute_start([part], self.mesh, self.axis, h if below else -h,
                                 log).wait()[0]
            if not (0 <= idx + (h if below else -h) < self.n):
                nb = torch.zeros_like(nb)
            if below:
                parts.append(nb)
            else:
                parts.insert(0, nb)
            left -= take
            h += 1
        return torch.cat(parts, dim=1)

    def __call__(self, R1_loc, R0_loc, W1: M.ExactWeights, feats1: M.LevelFeatures,
                 feats0: M.LevelFeatures) -> M.Matches:
        R1_loc, R0_loc = _local(R1_loc), _local(R0_loc)
        T0, T1, n = self.T0, self.T1, self.n
        if R0_loc.shape[1] % T0 != 0:
            raise ValueError(
                "row stripes must be multiples of T0: the walk's stride-T0 "
                "placement grid is phase-locked to global rows, so each "
                "stripe's y_origin must land on the grid "
                f"(H0/n = {R0_loc.shape[1]}, T0 = {T0})")
        if R1_loc.shape[1] % T1 != 0:
            raise ValueError(
                "row stripes must be multiples of T1 at level 1: anchor cells "
                "are phase-locked to the GLOBAL T1 grid, and the global-cell "
                "re-base idx * (H1/n // T1) floors otherwise — positions "
                "would silently shift vs the single-device engine "
                f"(H1/n = {R1_loc.shape[1]}, T1 = {T1}; level-0 stripes must "
                f"be multiples of lcm(2*T1, T0))")
        idx = self.mesh.get_local_rank(self.axis)
        log = self.last_collectives = {}
        R1x = torch.cat([R1_loc, self._pull(R1_loc, self.halo1, True, idx, log)], dim=1)
        R0x = torch.cat([self._pull(R0_loc, self.UP, False, idx, log), R0_loc,
                         self._pull(R0_loc, self.halo0, True, idx, log)], dim=1)
        Hc_loc = R1_loc.shape[1] // T1  # anchor cells owned by this stripe
        raw = M.coarse_scores_gemm(R1x, W1, T1, self.Kc1, self.plain)[:, :Hc_loc, :]
        Hc, Wc = raw.shape[1:]
        # Validity against the GLOBAL frame height: rows re-based.
        dev = raw.device
        ii = torch.arange(Hc, dtype=torch.int32, device=dev)[:, None] + idx * Hc_loc
        jj = torch.arange(Wc, dtype=torch.int32, device=dev)[None, :]
        h = feats1.size[:, 0][:, None, None]
        w = feats1.size[:, 1][:, None, None]
        vpos = (ii[None] * T1 + h <= R1_loc.shape[1] * n) & (jj[None] * T1 + w <= Wc * T1)
        cand = M.select_candidates(raw, feats1.count, vpos, self.sel_thr, self.top_k)
        # The walk runs in global coordinates: global cell rows, the global
        # frame's borders (total_hw) and R0x's first row (y_origin).
        H0_loc = R0_loc.shape[1]
        cand = cand._replace(cell_y=cand.cell_y + idx * (H0_loc // (2 * T1)))
        ref = M.refine_candidates_opencv_batched(
            R0x[None], feats0, M.CoarseMatches(*(a[None] for a in cand)), T1,
            self.threshold, E0=self.E0, fine_T=T0, total_hw=(H0_loc * n, R0_loc.shape[2]),
            y_origin=idx * H0_loc - self.UP, plain=self.plain)
        merged = _merge_topk(ref, self.top_k, self.threshold, self.mesh, self.axis, log)
        return M.Matches(*(a[0] for a in merged))


make_row_sharded_matcher = RowShardedMatcher


class RingDetectStep:
    """Ring-pipelined bank rotation: step(rgbs, depths, bank) -> Matches
    (B_local, top_k) (make_ring_detect_step, the reference's name, builds
    one).  Frames are data-parallel over `axis` (each rank preprocesses
    its own once); the bank is sharded 1/n per rank and rotates: at step t
    rank d scores its frames against shard (d - t) mod n with the
    exhaustive scores, walks them with that shard's level-0 features,
    folds the result into a running top-k (ids + shard * n_local) and
    takes the next shard from its ring neighbour, whose hop was posted
    before the step's scores.  After n steps every frame has met every
    template with no all-gather.  `plain` and `last_collectives` as in
    ShardedDetectStep."""

    def __init__(self, mesh: DeviceMesh, axis: str, T1: int, Kc1: int, top_k: int,
                 threshold: float, T0: int = 5, E0: int = 96, use_depth: bool = False,
                 coarse_margin: float = 5.0, weak_threshold: float = 10.0,
                 plain: bool = False):
        self.mesh, self.axis = mesh, axis
        self.n = _mesh_size(mesh, axis)
        self.T0, self.T1, self.Kc1, self.E0 = T0, T1, Kc1, E0
        self.top_k, self.threshold = top_k, threshold
        self.use_depth, self.weak = use_depth, weak_threshold
        self.sel_thr = max(threshold - coarse_margin, 0.0)
        self.plain = plain
        self.last_collectives: dict[str, int] = {}

    def __call__(self, rgbs, depths, bank: RingBank) -> M.Matches:
        dev = bank.feats1.count.device
        rgbs = _local(rgbs).to(dev)
        depths = _local(depths)
        depths = None if depths is None else depths.to(dev)
        R0, R1 = M.preprocess_frames_batched(
            rgbs, depths, T0=self.T0, T1=self.T1, use_depth=self.use_depth,
            weak_threshold=self.weak, plain=self.plain)
        B, k, n = R1.shape[0], self.top_k, self.n
        Hc, Wc = R1.shape[2] // self.T1, R1.shape[3] // self.T1
        n_local = bank.feats1.oris.shape[0]
        d = self.mesh.get_local_rank(self.axis)
        z = torch.zeros((B, k), dtype=torch.int32, device=dev)
        best = M.Matches(z, z, z, torch.full((B, k), -1.0, device=dev),
                         torch.zeros((B, k), dtype=torch.bool, device=dev))
        thr = torch.tensor(self.threshold, dtype=torch.float32, device=dev)
        log = self.last_collectives = {}
        W1, feats1, feats0 = bank.W1, bank.feats1, bank.feats0
        for t in range(n):
            # The next shard's features go on the wire before this step's
            # scores; its exact weights are built from them on arrival.
            if t + 1 < n:
                nxt = _ppermute_start([*feats1, *feats0], self.mesh, self.axis, -1, log)
            vpos = M.position_validity_flat(feats1.size, self.T1, Hc, Wc)
            raw = M.coarse_scores_gemm_flat_batched(R1, W1, self.T1, self.Kc1, self.plain)
            cand = M.select_candidates_flat(raw, feats1.count, vpos, self.sel_thr, k, Wc,
                                            self.plain)
            ref = M.refine_candidates_opencv_batched(
                R0, feats0, cand, self.T1, self.threshold, E0=self.E0, fine_T=self.T0,
                plain=self.plain)
            shard_id = (d - t) % n  # the shard this rank holds now
            cat = lambda a, b: torch.cat([a, b], dim=1)
            vals, idx = M._topk_first_index(
                torch.where(cat(best.valid, ref.valid),
                            cat(best.similarity, ref.similarity), -1.0), k)
            take = lambda a, b: torch.gather(cat(a, b), 1, idx)
            best = M.Matches(
                template_id=take(best.template_id, ref.template_id + shard_id * n_local),
                x=take(best.x, ref.x), y=take(best.y, ref.y), similarity=vals,
                valid=take(best.valid, ref.valid) & (vals >= thr))
            if t + 1 < n:
                got = nxt.wait()
                feats1, feats0 = M.LevelFeatures(*got[:5]), M.LevelFeatures(*got[5:])
                W1 = M.exact_weights(feats1, R1.shape[1], self.T1, self.Kc1)
        return best


make_ring_detect_step = RingDetectStep
