"""PyTorch port vs the JAX reference: the per-frame-cap pruning functions
of the `positions` and `two_axis` modes (ops/match.py), on the synthetic
banks of tests/test_prune.py, on CPU.

Covered: prune_positions_batched, the direct survivor patch gather against
both of the reference's gathers and the port's one-hot plain version,
coarse_scores_gemm_flat_batched_pos, fine_ub_at_survivors,
fine_plan_from_ub, match_coarse_pruned_fine_with_fallback (no overflow,
fine overflow, coarse overflow), match_coarse_pruned_with_fallback,
match_coarse_pruned_multiclass, prune_templates_batched,
prune_plan_batched, the _sub and _sub2 GEMMs and selects, _default_cap.

Tolerance: exact equality of every output — plan records field for
field (dead slots included), candidate ids, cells and order
(sub-threshold filler slots included), f32 similarities as bits, valid
masks, counts and overflow flags.  The reference's selects default to
approx_max_k, which is an exact top-k on the CPU.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _xdist_threads  # noqa: F401  (PyTorch threads per xdist worker)

sys.path.insert(0, "tests")
from test_prune import C, KC, T1, _bank, _frames, _plant  # noqa: E402

from linemod_pose_estimation_tpu.ops import match as JM  # noqa: E402
from linemod_pose_estimation_tpu_torch import convert  # noqa: E402
from linemod_pose_estimation_tpu_torch.ops import features as TF  # noqa: E402
from linemod_pose_estimation_tpu_torch.ops import match as TM  # noqa: E402

G = 4
THR = 80.0
TOP_K = 32  # <= m_cap * N at m_cap 1, so every branch has one shape (lax.cond)


class Scene:
    """One synthetic bank and response batch, as both packages hold them."""

    def __init__(self, kind: str):
        rng = np.random.default_rng(5)
        n = 40
        self.jf = _bank(rng, n)
        if kind == "ties":
            # One template planted at many cells of an otherwise empty frame:
            # those cells share the full margin, their neighbours share
            # lower ones, so the top-k's tie rule decides the plan's order.
            Rb = np.zeros((2, C, 160, 160), np.uint8)
            for b in range(2):
                for py in range(0, 14, 3):
                    for px in range(0, 14, 3):
                        Rb = _plant(Rb, self.jf, 7, b, py, px)
        else:
            Rb = np.array(_frames(rng, b=1 if kind == "single" else 3,
                                  sparse=0.5, hi=3))
            plants = [(5, 0, 3, 4), (31, 0, 8, 2), (12, 0, 12, 11), (20, 0, 5, 13),
                      (3, 0, 0, 9), (35, 0, 13, 0), (31, 1, 7, 9), (12, 1, 2, 11),
                      (8, 1, 10, 13), (27, 1, 13, 4)]
            for tid, b, py, px in plants:
                if b < Rb.shape[0]:
                    Rb = _plant(Rb, self.jf, tid, b, py, px)
            if Rb.shape[0] == 3:
                Rb[2] = 0  # an empty frame
        self.Rb = Rb
        self.jR = jnp.asarray(Rb)
        self.tR = torch.from_numpy(Rb)
        self.B = Rb.shape[0]
        self.Hc, self.Wc = Rb.shape[2] // T1, Rb.shape[3] // T1
        self.P = self.Hc * self.Wc
        self.jW = (JM.build_gemm_weights(self.jf, C, T1, KC),
                   JM.build_cell_weights(self.jf, C, T1, KC),
                   JM.build_cell_weights_fine(self.jf, C, T1, KC, G))
        self.jvpos = JM.position_validity_flat(self.jf.size, T1, self.Hc, self.Wc)
        self.tf = convert.level_features_from_numpy(
            *(np.asarray(a) for a in self.jf), device="cpu")
        self.tW = convert.bank_from_numpy(*self.jW, device="cpu")
        self.tvpos = TM.position_validity_flat(self.tf.size, T1, self.Hc, self.Wc)


_SCENES: dict[str, Scene] = {}


def scene(kind: str) -> Scene:
    if kind not in _SCENES:
        _SCENES[kind] = Scene(kind)
    return _SCENES[kind]


def _eq(got, want, what=""):
    """A port record equals the reference's, field for field."""
    assert len(got) == len(want)
    for name, a, b in zip(want._fields, got, want):
        b = np.asarray(b)
        a = a.numpy()
        if b.dtype == np.float32:  # equal as f32 bits
            assert a.dtype == np.float32
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}{name}")


def _jstack(per_frame):
    return JM.CoarseMatches(*(jnp.stack(a) for a in zip(*per_frame)))


# ---------------------------------------------------------------------------
# The coarse plan
# ---------------------------------------------------------------------------

# (scene, m_cap)
PLAN_CASES = {"ample": ("sparse", 400), "cap_2": ("sparse", 2), "cap_1": ("sparse", 1),
              "b1": ("single", 64), "b1_cap_1": ("single", 1),
              "ties": ("ties", 400), "ties_capped": ("ties", 9)}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_prune_positions_batched(case):
    kind, m_cap = PLAN_CASES[case]
    s = scene(kind)
    want = JM.prune_positions_batched(s.jR, s.jW[1], s.jf.count, s.jvpos, THR, T1,
                                      KC, m_cap)
    got = TM.prune_positions_batched(s.tR, s.tW.W_cell, s.tf.count, s.tvpos, THR,
                                     T1, KC, m_cap)
    _eq(got, want)
    assert got.p_idx.shape == (s.B, min(m_cap, s.P))
    assert int(got.m_survivors.max()) > 0
    assert bool(got.overflow) == (case in ("cap_2", "cap_1", "b1_cap_1", "ties_capped"))
    if kind == "ties":  # many kept positions do share one margin
        margins = TM.position_margins_batched(s.tR, s.tW.W_cell, s.tf.count, s.tvpos,
                                              THR, T1, KC)
        kept = margins[0][got.p_idx[0].long()][got.p_keep[0]]
        assert kept.numel() - kept.unique().numel() >= 8


@pytest.mark.parametrize("kind", ["sparse", "ties"])
def test_survivor_patch_gathers(kind):
    """The direct gather equals the reference's row gather and its one-hot
    gather, and the port's own one-hot plain version."""
    s = scene(kind)
    pp = TM.prune_positions_batched(s.tR, s.tW.W_cell, s.tf.count, s.tvpos, THR,
                                    T1, KC, 24)
    jp = jnp.asarray(pp.p_idx.numpy())
    got = TM.assemble_survivor_patches(s.tR, pp.p_idx, T1, KC)
    for use_pallas in (False, True):
        want = JM.assemble_survivor_patches(s.jR, jp, T1, KC, use_pallas=use_pallas)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    L4 = TF.linearize_responses_lanes(s.tR.to(torch.int8), T1, KC)
    onehot = TM.gather_cell_patches_onehot(L4, pp.p_idx, KC, s.Wc)
    assert torch.equal(onehot, got)
    want = JM.gather_cell_patches_onehot(jnp.asarray(L4.numpy()), jp, KC, s.Wc)
    np.testing.assert_array_equal(onehot.numpy(), np.asarray(want))
    assert int(got.max()) > 0


@pytest.mark.parametrize("m_cap", [24, 2, 1])
def test_survivor_gemm_and_fine_bound(m_cap):
    s = scene("sparse")
    pp = TM.prune_positions_batched(s.tR, s.tW.W_cell, s.tf.count, s.tvpos, THR,
                                    T1, KC, m_cap)
    jp = jnp.asarray(pp.p_idx.numpy())
    raw = TM.coarse_scores_gemm_flat_batched_pos(s.tR, s.tW.exact, pp.p_idx, T1, KC)
    want = JM.coarse_scores_gemm_flat_batched_pos(s.jR, s.jW[0], jp, T1, KC)
    np.testing.assert_array_equal(raw.numpy(), np.asarray(want))
    ubf = TM.fine_ub_at_survivors(s.tR, pp.p_idx, s.tW.W_fine, T1, KC, G)
    want = JM.fine_ub_at_survivors(s.jR, jp, s.jW[2], T1, KC, G)
    np.testing.assert_array_equal(ubf.numpy(), np.asarray(want))
    assert bool((ubf >= raw).all())  # the bound dominates the exact score


@pytest.mark.parametrize("kind,m2_cap", [("sparse", 400), ("sparse", 3), ("sparse", 1),
                                         ("ties", 400), ("ties", 5), ("single", 2)])
def test_fine_plan_from_ub(kind, m2_cap):
    s = scene(kind)
    pp = TM.prune_positions_batched(s.tR, s.tW.W_cell, s.tf.count, s.tvpos, THR,
                                    T1, KC, 32)
    ubf = TM.fine_ub_at_survivors(s.tR, pp.p_idx, s.tW.W_fine, T1, KC, G)
    got = TM.fine_plan_from_ub(ubf, s.tf.count, s.tvpos, pp.p_idx, pp.p_keep, THR,
                               m2_cap)
    want = JM.fine_plan_from_ub(jnp.asarray(ubf.numpy()), s.jf.count, s.jvpos,
                                jnp.asarray(pp.p_idx.numpy()),
                                jnp.asarray(pp.p_keep.numpy()), THR, m2_cap)
    _eq(got, want)
    assert int(got.m_survivors.max()) > 0


# ---------------------------------------------------------------------------
# The positions matchers: every branch
# ---------------------------------------------------------------------------

# (scene, m_cap, m2_cap) -> which branch runs
FINE_CASES = {
    "no_overflow": ("sparse", 400, 400),
    "default_half_cap": ("sparse", 32, 16),
    "fine_overflow": ("sparse", 400, 1),
    "coarse_overflow": ("sparse", 2, 1),
    "coarse_overflow_cap_1": ("sparse", 1, 1),
    "b1": ("single", 64, 32),
    "b1_fine_overflow": ("single", 64, 1),
    "b1_coarse_overflow": ("single", 1, 1),
    "ties": ("ties", 400, 400),
    "ties_fine_overflow": ("ties", 400, 4),
    "ties_coarse_overflow": ("ties", 9, 4),
}


def _exhaustive_valid_sets(s: Scene, threshold=THR):
    raw = TM.coarse_scores_gemm_flat_batched(s.tR, s.tW.exact, T1, KC)
    ex = TM.select_candidates_flat(raw, s.tf.count, s.tvpos, threshold, 4 * TOP_K, s.Wc)
    return [_valid_set(ex, b) for b in range(s.B)]


def _valid_set(cm, b):
    return {(int(t), int(y), int(x), float(v)) for t, y, x, v, ok in
            zip(cm.template_id[b], cm.cell_y[b], cm.cell_x[b], cm.similarity[b],
                cm.valid[b]) if ok}


@pytest.mark.parametrize("case", list(FINE_CASES))
def test_match_coarse_pruned_fine_with_fallback(case):
    kind, m_cap, m2_cap = FINE_CASES[case]
    s = scene(kind)
    jc, jpp, jfp = JM.match_coarse_pruned_fine_with_fallback(
        s.jR, *s.jW, s.jf.count, s.jvpos, THR, T1, KC, G, m_cap, m2_cap, TOP_K, s.Wc)
    tc, tpp, tfp = TM.match_coarse_pruned_fine_with_fallback(
        s.tR, s.tW.exact, s.tW.W_cell, s.tW.W_fine, s.tf.count, s.tvpos, THR, T1,
        KC, G, m_cap, m2_cap, TOP_K, s.Wc)
    _eq(tc, jc, "cands.")
    _eq(tpp, jpp, "prune.")
    _eq(tfp, jfp, "fine.")
    assert bool(tpp.overflow) == ("coarse_overflow" in case)
    assert bool(tfp.overflow) == ("fine_overflow" in case)
    if "coarse_overflow" in case:  # the placeholder plan holds nothing
        assert not bool(tfp.p_keep.any()) and int(tfp.m_survivors.sum()) == 0
    # exact in every branch: the valid set is the exhaustive engine's
    want_sets = _exhaustive_valid_sets(s)
    assert sum(len(w) for w in want_sets) > 0
    for b in range(s.B):
        if len(want_sets[b]) < TOP_K:
            assert _valid_set(tc, b) == want_sets[b]


@pytest.mark.parametrize("case,kind,m_cap", [
    ("pruned", "sparse", 400), ("overflow", "sparse", 2), ("b1_cap_1", "single", 1),
    ("ties", "ties", 400)])
def test_match_coarse_pruned_with_fallback(case, kind, m_cap):
    s = scene(kind)
    jc, jpp = JM.match_coarse_pruned_with_fallback(
        s.jR, s.jW[0], s.jW[1], s.jf.count, s.jvpos, THR, T1, KC, m_cap, TOP_K, s.Wc)
    tc, tpp = TM.match_coarse_pruned_with_fallback(
        s.tR, s.tW.exact, s.tW.W_cell, s.tf.count, s.tvpos, THR, T1, KC, m_cap,
        TOP_K, s.Wc)
    _eq(tc, jc, "cands.")
    _eq(tpp, jpp, "prune.")
    assert bool(tpp.overflow) == (case in ("overflow", "b1_cap_1"))
    assert int(tc.valid.sum()) > 0


def test_fine_g_must_divide_T():
    s = scene("single")
    with pytest.raises(ValueError, match="must divide"):
        TM.match_coarse_pruned_fine_with_fallback(
            s.tR, s.tW.exact, s.tW.W_cell, s.tW.W_fine, s.tf.count, s.tvpos, THR,
            T1, KC, 3, 8, 4, TOP_K, s.Wc)


# (m_cap, m2_cap, g)
MULTI_CASES = {"fine": (64, None, G), "fine_overflow": (64, 1, G),
               "coarse_overflow": (2, None, G), "no_fine_stage": (64, None, None),
               "no_fine_stage_overflow": (1, None, None)}
SLICES = ((0, 16), (16, 40))
THRS = (80.0, 84.0)


@pytest.mark.parametrize("case", list(MULTI_CASES))
def test_match_coarse_pruned_multiclass(case):
    m_cap, m2_cap, g = MULTI_CASES[case]
    s = scene("sparse")
    jc, jpp = JM.match_coarse_pruned_multiclass(
        s.jR, *s.jW, s.jf.count, s.jvpos, SLICES, THRS, T1, KC, m_cap, TOP_K, s.Wc,
        g=g, m2_cap=m2_cap)
    tc, tpp = TM.match_coarse_pruned_multiclass(
        s.tR, s.tW.exact, s.tW.W_cell, s.tW.W_fine, s.tf.count, s.tvpos, SLICES,
        THRS, T1, KC, m_cap, TOP_K, s.Wc, g=g, m2_cap=m2_cap)
    assert len(tc) == len(jc) == 2
    for i in range(2):
        _eq(tc[i], jc[i], f"class {i} cands.")
        lo, hi = SLICES[i]
        ids = tc[i].template_id[tc[i].valid]
        assert bool(((ids >= lo) & (ids < hi)).all())  # only its own columns
    _eq(tpp, jpp, "prune.")
    assert bool(tpp.overflow) == ("overflow" in case and case != "fine_overflow")
    assert int(tc[0].valid.sum()) > 0 and int(tc[1].valid.sum()) > 0


def test_multiclass_no_w_fine_skips_the_fine_stage():
    s = scene("sparse")
    args = (s.tf.count, s.tvpos, SLICES, THRS, T1, KC, 64, TOP_K, s.Wc)
    a, _ = TM.match_coarse_pruned_multiclass(s.tR, s.tW.exact, s.tW.W_cell, None,
                                             *args, g=G)
    b, _ = TM.match_coarse_pruned_multiclass(s.tR, s.tW.exact, s.tW.W_cell,
                                             s.tW.W_fine, *args, g=None)
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            assert torch.equal(u, v)


def test_multiclass_g_must_divide_T():
    s = scene("single")
    for M_, R, W, f, v in ((TM, s.tR, (s.tW.exact, s.tW.W_cell, s.tW.W_fine), s.tf,
                            s.tvpos), (JM, s.jR, s.jW, s.jf, s.jvpos)):
        with pytest.raises(ValueError, match="g=3 must divide T=8"):
            M_.match_coarse_pruned_multiclass(R, *W, f.count, v, SLICES, THRS, T1, KC,
                                              8, TOP_K, s.Wc, g=3)


def test_default_cap():
    for M_ in (TM, JM):
        assert M_._default_cap(None, 256, "c") == 128
        assert M_._default_cap(None, 1, "c") == 1
        assert M_._default_cap(7, 256, "c") == 7
        with pytest.raises(ValueError, match="must be positive"):
            M_._default_cap(0, 256, "c")


# ---------------------------------------------------------------------------
# two_axis: template-axis and both-axes compaction, no fallback
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,thr,n_cap", [("sparse", THR, 40), ("sparse", 30.0, 6),
                                            ("ties", THR, 40), ("single", 30.0, 1)])
def test_prune_templates_batched_and_sub(kind, thr, n_cap):
    s = scene(kind)
    want = JM.prune_templates_batched(s.jR, s.jW[1], s.jf.count, s.jvpos, thr, T1,
                                      KC, n_cap)
    got = TM.prune_templates_batched(s.tR, s.tW.W_cell, s.tf.count, s.tvpos, thr, T1,
                                     KC, n_cap)
    _eq(got, want)
    assert bool(got.overflow) == (n_cap < 40)
    assert int(got.keep.sum()) == min(n_cap, int(got.n_survivors)) > 0
    raw = TM.coarse_scores_gemm_flat_batched_sub(s.tR, s.tW.exact, got.idx, T1, KC)
    jraw = JM.coarse_scores_gemm_flat_batched_sub(s.jR, jnp.asarray(s.jW[0]).T,
                                                  want.idx, T1, KC)
    np.testing.assert_array_equal(raw.numpy(), np.asarray(jraw))
    sel = TM.select_candidates_flat_sub(raw, s.tf.count, s.tvpos, got.idx, got.keep,
                                        thr, TOP_K, s.Wc)
    jsel = _jstack([JM.select_candidates_flat_sub(jraw[b], s.jf.count, s.jvpos, want.idx,
                                                  want.keep, thr, TOP_K, s.Wc)
                    for b in range(s.B)])
    _eq(sel, jsel, "select.")


# (scene, threshold, n_cap, m_cap): which axis overflows
PLAN2_CASES = {"ample": ("sparse", THR, 40, 400, False),
               "positions_over": ("sparse", THR, 40, 2, True),
               "templates_over": ("sparse", 30.0, 6, 400, True),
               "both_over_b1": ("single", 30.0, 1, 1, True),
               "ties": ("ties", THR, 40, 400, False),
               "ties_capped": ("ties", THR, 40, 9, True)}


@pytest.mark.parametrize("case", list(PLAN2_CASES))
def test_prune_plan_batched_and_sub2(case):
    kind, thr, n_cap, m_cap, overflow = PLAN2_CASES[case]
    s = scene(kind)
    want = JM.prune_plan_batched(s.jR, s.jW[1], s.jf.count, s.jvpos, thr, T1, KC,
                                 n_cap, m_cap)
    got = TM.prune_plan_batched(s.tR, s.tW.W_cell, s.tf.count, s.tvpos, thr, T1, KC,
                                n_cap, m_cap)
    _eq(got, want)
    assert bool(got.overflow) == overflow
    # over capacity the highest-bound entries are kept, every slot live
    if int(got.n_survivors) > n_cap:
        assert bool(got.t_keep.all())
    raw = TM.coarse_scores_gemm_flat_batched_sub2(s.tR, s.tW.exact, got.t_idx,
                                                  got.p_idx, T1, KC)
    jraw = JM.coarse_scores_gemm_flat_batched_sub2(
        s.jR, jnp.asarray(s.jW[0]).T, want.t_idx, want.p_idx, T1, KC)
    np.testing.assert_array_equal(raw.numpy(), np.asarray(jraw))
    sel = TM.select_candidates_flat_sub2(raw, s.tf.count, s.tvpos, got.t_idx,
                                         got.t_keep, got.p_idx, got.p_keep, thr,
                                         TOP_K, s.Wc)
    jsel = _jstack([JM.select_candidates_flat_sub2(
        jraw[b], s.jf.count, s.jvpos, want.t_idx, want.t_keep, want.p_idx[b],
        want.p_keep[b], thr, TOP_K, s.Wc) for b in range(s.B)])
    _eq(sel, jsel, "select.")
    if not overflow:  # exact while nothing overflows
        want_sets = _exhaustive_valid_sets(s, thr)
        for b in range(s.B):
            if len(want_sets[b]) < TOP_K:
                assert _valid_set(sel, b) == want_sets[b]


def test_topk_first_index_int32_ties():
    """The int32 top-k keeps the lower index among equal values, as the
    f32 one does, and as jax.lax.top_k."""
    import jax

    rng = np.random.default_rng(0)
    v = rng.integers(-3, 4, size=(4, 50)).astype(np.int32)
    v[0, :] = -(2**30)
    for k in (1, 7, 50):
        jv, ji = jax.lax.top_k(jnp.asarray(v), k)
        tv, ti = TM._topk_first_index(torch.from_numpy(v), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
