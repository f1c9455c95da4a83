"""Many classes through one merged bank: each class's selects read only its
own columns of the merged template axis (ops/match.py::ClassColumns), and
the result is what the masked selects over every column give, bit for bit.

- The class-window selects (select_candidates_flat_pos: the pooled and
  per-frame-cap tiers; select_candidates_flat: the exhaustive fallback, TK's
  plain twin here) against the masked selects over the whole axis: ids,
  similarities, valid flags and the sub-threshold filler slots, at C = 1,
  2 and 8 classes of unequal widths, with few live entries, frames with no
  row of their own and top_k past a window's entries.
- match_pooled_multiclass and match_coarse_pruned_multiclass with the
  classes' windows against the same calls with masked whole-axis columns
  (the computation before the windows), every output, at C = 1, 2 and 8,
  in each pool case; at C = 8 also the JAX reference's, with merge, the
  walk at 8 x TOP_K slots and the split.
- The split of every class in one top-k against one top-k a class.
- MultiClassBatchedMatcher(prune_mode="pooled") with eight classes of
  unequal sizes drawn from the committed RGB-D bank, at mixed thresholds,
  B = 4 (the cascade frames with seeded noise), against the benchmark's
  plain reference (benchmark/reference/multiclass.py: each class's bank
  matched alone at its threshold), per class and frame as multisets of
  valid matches: pools that hold, a select-row overflow and a coarse
  overflow (both take the fallback), and plain=True.
- The fine pool's counters move as last_pool says.

Tolerance: exact equality everywhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _xdist_threads  # noqa: F401  (PyTorch threads per xdist worker)

from benchmark.reference import bank as RB
from benchmark.reference import matcher as RM
from benchmark.reference.multiclass import MultiClassReference
from linemod_pose_estimation_tpu.ops import match as JM
from linemod_pose_estimation_tpu_torch import convert
from linemod_pose_estimation_tpu_torch.models.detector import Detector
from linemod_pose_estimation_tpu_torch.models.serving import MultiClassBatchedMatcher
from linemod_pose_estimation_tpu_torch.models.templates import TemplateBank
from linemod_pose_estimation_tpu_torch.ops import match as TM
from linemod_pose_estimation_tpu_torch.utils import tracing


def _assert_equal(got, want, what=""):
    for name, a, b in zip(got._fields, got, want):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype == np.float32:  # compare the bits: -0.0 is not 0.0
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}{name}")


def _slices(widths):
    bases = np.concatenate([[0], np.cumsum(widths)]).tolist()
    return tuple(zip(bases[:-1], bases[1:]))


def _masked(vpos, slices, thrs):
    """The classes as the masked selects saw them: every column, the
    others' dead."""
    col = torch.arange(vpos.shape[1])
    return [TM.ClassColumns(0, vpos.shape[1], vpos & ((col >= lo) & (col < hi))[None], t)
            for (lo, hi), t in zip(slices, thrs)]


# ---------------------------------------------------------------------------
# The selects alone
# ---------------------------------------------------------------------------

WIDTHS = {1: [37], 2: [13, 24], 8: [3, 7, 2, 9, 5, 4, 6, 8]}
SELECT_CASES = ["dense", "sparse", "frame_without_rows", "k_past_window"]


def _select_operands(case, C, seed):
    g = torch.Generator().manual_seed(seed)
    B, P, m = 3, 20, 6
    N = sum(WIDTHS[C])
    raw = torch.randint(0, 60, (B, m, N), generator=g, dtype=torch.int32)
    raw[:, :, ::5] = 30  # ties within and across the classes
    count = torch.randint(10, 64, (N,), generator=g, dtype=torch.int32)
    p_idx = torch.randint(0, P, (B, m), generator=g)
    p_keep = torch.rand((B, m), generator=g) < 0.7
    live = {"dense": 0.9, "sparse": 0.02, "frame_without_rows": 0.5, "k_past_window": 0.9}
    vpos = torch.rand((P, N), generator=g) < live[case]
    if case == "frame_without_rows":
        p_keep[1] = False
    top_k = 64 if case == "k_past_window" else 12
    return raw, count, vpos, p_idx, p_keep, top_k, P


@pytest.mark.parametrize("C", sorted(WIDTHS))
@pytest.mark.parametrize("case", SELECT_CASES)
def test_class_window_selects_equal_the_masked_ones(case, C):
    raw, count, vpos, p_idx, p_keep, top_k, P = _select_operands(case, C, 7 * C)
    slices = _slices(WIDTHS[C])
    thrs = [float(t) for t in np.linspace(40.0, 70.0, C)]
    Wc = 5
    raw_full = torch.randint(0, 60, (raw.shape[0], P, raw.shape[2]),
                             generator=torch.Generator().manual_seed(C), dtype=torch.int32)
    fillers = 0
    for win, mask in zip(TM._class_columns(vpos, slices, thrs), _masked(vpos, slices, thrs)):
        assert win.vpos.shape == (P, win.hi - win.lo)
        got = TM.select_candidates_flat_pos(raw, count, win.vpos, p_idx, p_keep, win.threshold,
                                            top_k, Wc, win.lo)
        want = TM.select_candidates_flat_pos(raw, count, mask.vpos, p_idx, p_keep,
                                             mask.threshold, top_k, Wc)
        _assert_equal(got, want, f"pooled class {win.lo}: ")
        fillers += int((got.similarity == -1.0).sum())
        # the exhaustive select (TK's plain twin on the CPU), its window read in place
        for plain in (False, True):
            got = TM.select_candidates_flat(raw_full, count, win.vpos, win.threshold, top_k, Wc,
                                            plain, win.lo)
            want = TM.select_candidates_flat(raw_full, count, mask.vpos, mask.threshold, top_k,
                                             Wc, plain)
            _assert_equal(got, want, f"exhaustive class {win.lo}: ")
    if case != "dense" and C > 1:
        assert fillers > 0, "no filler slot: the case does not test them"


def test_split_of_every_class_in_one_topk_equals_one_a_class():
    """split_matches_stacked's one top-k over (B, C, S) keys against the
    per-class top-k over each class's slots, at 8 x 128 slots a frame with
    ties within and across the classes."""
    g = torch.Generator().manual_seed(5)
    B, C, K = 3, 8, 128
    widths = [40, 25, 60, 33, 41, 17, 50, 29]
    slices = _slices(widths)
    N = sum(widths)
    m = TM.Matches(template_id=torch.randint(0, N, (B, C * K), generator=g, dtype=torch.int32),
                   x=torch.arange(C * K, dtype=torch.int32).repeat(B, 1),
                   y=torch.randint(0, 480, (B, C * K), generator=g, dtype=torch.int32),
                   similarity=torch.randint(80, 100, (B, C * K), generator=g).to(torch.float32),
                   valid=torch.rand((B, C * K), generator=g) < 0.6)
    got = TM.split_matches_by_class(m, slices, K)
    for (lo, hi), mc in zip(slices, got):
        mine = m.valid & (m.template_id >= lo) & (m.template_id < hi)
        key = torch.where(mine, m.similarity, float("-inf"))
        _, idx = TM._topk_first_index(key, K)
        take = lambda a: torch.gather(a, 1, idx)
        want = TM.Matches(take(m.template_id) - lo, take(m.x), take(m.y), take(m.similarity),
                          take(mine))
        _assert_equal(mc, want, f"class {lo}: ")
        assert mc.template_id.dtype == torch.int32


# ---------------------------------------------------------------------------
# The merged matcher's functions: windows against masks, and against JAX
# ---------------------------------------------------------------------------

T0, T1, E1, E0 = 5, 8, 24, 48
KC = (E1 - 1) // T1 + 1
H, W = 120, 160
HC, WC = (H // 2) // T1, (W // 2) // T1
TOP_K = 32
# template counts and Fmax of the synthetic classes
SIZES = {1: [(24, 14)], 2: [(24, 14), (40, 10)],
         8: [(24, 14), (40, 10), (9, 12), (31, 8), (17, 14), (12, 9), (28, 11), (20, 13)]}
THRS8 = (85.0, 88.0, 84.0, 90.0, 86.0, 85.0, 89.0, 87.0)
# (pool1, pool2, r_cap)
POOLS = {"pooled": (256, 128, 256), "fine_overflow": (256, 2, 256),
         "coarse_overflow": (2, 2, 256), "select_overflow": (256, 128, 1)}


def _bank(n, fmax, extent, seed):
    rng = np.random.default_rng(seed)
    offs = rng.integers(0, extent, size=(n, fmax, 2)).astype(np.int32)
    oris = rng.integers(0, 8, size=(n, fmax)).astype(np.int32)
    return (offs, oris, np.ones((n, fmax), bool), np.full((n,), fmax, np.int32),
            np.full((n, 2), extent, np.int32))


@pytest.fixture(scope="module")
def scene():
    rgb = np.random.default_rng(7).integers(0, 255, size=(H, W, 3), dtype=np.uint8)
    pyr = JM.preprocess_frame(jnp.asarray(rgb), None, T0=T0, T1=T1, use_depth=False)
    R0, R1 = JM.stack_modalities(pyr, False)
    return R0[None], R1[None]


def _synthetic(C, pkg):
    fields1 = [_bank(n, f, E1, 10 * C + i) for i, (n, f) in enumerate(SIZES[C])]
    fields0 = [_bank(n, f, E0, 10 * C + i + 100) for i, (n, f) in enumerate(SIZES[C])]
    if pkg == "j":
        lf = lambda fs: JM.LevelFeatures(*(jnp.asarray(a) for a in fs))
        f1, bases = JM.concat_level_features([lf(f) for f in fields1])
        f0, _ = JM.concat_level_features([lf(f) for f in fields0])
    else:
        lf = lambda fs: convert.level_features_from_numpy(*fs, device="cpu")
        f1, bases = TM.concat_level_features([lf(f) for f in fields1])
        f0, _ = TM.concat_level_features([lf(f) for f in fields0])
    ends = bases[1:] + (sum(n for n, _ in SIZES[C]),)
    return f1, f0, tuple(zip(bases, ends))


def _torch_weights(f1):
    return (TM.exact_weights(f1, 8, T1, KC),
            TM.MatmulWeight.from_nk(TM.build_cell_weights(f1, 8, T1, KC)),
            TM.MatmulWeight.from_nk(TM.build_cell_weights_fine(f1, 8, T1, KC, 4)))


@pytest.mark.parametrize("C", sorted(SIZES))
@pytest.mark.parametrize("case", list(POOLS))
def test_pooled_multiclass_windows_equal_masks(scene, C, case):
    pool1, pool2, r_cap = POOLS[case]
    R0, R1 = (torch.from_numpy(np.array(a)) for a in scene)
    f1, _, slices = _synthetic(C, "t")
    Wg, Wc_, Wf = _torch_weights(f1)
    sel = [t - 5.0 for t in THRS8[:C]]
    vpos = TM.position_validity_flat(f1.size, T1, HC, WC)
    out = []
    for classes in (TM._class_columns(vpos, slices, sel), _masked(vpos, slices, sel)):
        out.append(TM.match_pooled_multiclass(
            R1, Wg, Wc_, Wf, f1.count, vpos, slices, sel, T1, KC, 4, pool1=pool1,
            pool2=pool2, top_k=TOP_K, Wc=WC, r_cap=r_cap, classes=classes))
    (gc, gn, gs), (wc, wn, ws) = out
    for i in range(C):
        _assert_equal(gc[i], wc[i], f"class {i}: ")
        assert torch.equal(gn[i], wn[i])
    _assert_equal(gs, ws, "stats: ")
    assert bool(gs.fallback) == (case in ("coarse_overflow", "select_overflow"))
    assert sum(int(c.valid.sum()) for c in gc) > 0


@pytest.mark.parametrize("C", sorted(SIZES))
def test_positions_multiclass_windows_equal_masks(scene, C):
    R1 = torch.from_numpy(np.array(scene[1]))
    f1, _, slices = _synthetic(C, "t")
    Wg, Wc_, Wf = _torch_weights(f1)
    sel = [t - 5.0 for t in THRS8[:C]]
    vpos = TM.position_validity_flat(f1.size, T1, HC, WC)
    for m_cap in (64, 2):  # the survivors' scores; a coarse overflow: every position
        got, gp = TM.match_coarse_pruned_multiclass(
            R1, Wg, Wc_, Wf, f1.count, vpos, slices, sel, T1, KC, m_cap, TOP_K, WC,
            classes=TM._class_columns(vpos, slices, sel))
        want, wp = TM.match_coarse_pruned_multiclass(
            R1, Wg, Wc_, Wf, f1.count, vpos, slices, sel, T1, KC, m_cap, TOP_K, WC,
            classes=_masked(vpos, slices, sel))
        for i in range(C):
            _assert_equal(got[i], want[i], f"m_cap {m_cap} class {i}: ")
        _assert_equal(gp, wp)


@pytest.mark.parametrize("case", list(POOLS))
def test_eight_classes_equal_the_jax_reference(scene, case):
    """match_pooled_multiclass, merge (8 x TOP_K slots), the walk and the
    split at eight classes against the JAX package's functions."""
    pool1, pool2, r_cap = POOLS[case]
    sel = tuple(t - 5.0 for t in THRS8)
    jf1, jf0, slices = _synthetic(8, "j")
    tf1, tf0, tslices = _synthetic(8, "t")
    assert slices == tslices
    jR0, jR1 = scene
    tR0, tR1 = (torch.from_numpy(np.array(a)) for a in scene)
    jW = (JM.build_gemm_weights(jf1, 8, T1, KC), JM.build_cell_weights(jf1, 8, T1, KC),
          JM.build_cell_weights_fine(jf1, 8, T1, KC, 4))
    out = {}
    for pkg, M, R0, R1, f1, f0, Ws in (("j", JM, jR0, jR1, jf1, jf0, jW),
                                       ("t", TM, tR0, tR1, tf1, tf0, _torch_weights(tf1))):
        vpos = M.position_validity_flat(f1.size, T1, HC, WC)
        cands, nvs, stats = M.match_pooled_multiclass(
            R1, *Ws, f1.count, vpos, slices, sel, T1, KC, 4, pool1=pool1, pool2=pool2,
            top_k=TOP_K, Wc=WC, r_cap=r_cap)
        cat, nv = M.merge_candidates_sorted(cands)
        m = M.refine_candidates_opencv_batched(R0, f0, cat, T1, min(THRS8), E0=E0,
                                               fine_T=T0, n_valid=nv)
        out[pkg] = (cands, nvs, stats, cat, nv, m, M.split_matches_by_class(m, slices, TOP_K))
    (jc, jn, js, jcat, jnv, jm, jsp), (tc, tn, ts, tcat, tnv, tm, tsp) = out["j"], out["t"]
    assert tcat.template_id.shape[1] == 8 * TOP_K
    for i in range(8):
        _assert_equal(tc[i], jc[i], f"class {i} cands: ")
        np.testing.assert_array_equal(tn[i].numpy(), np.asarray(jn[i]))
        _assert_equal(tsp[i], jsp[i], f"class {i} split: ")
    _assert_equal(ts, js, "stats: ")
    _assert_equal(tcat, jcat, "merged: ")
    _assert_equal(tm, jm, "walk: ")


# ---------------------------------------------------------------------------
# MultiClassBatchedMatcher with eight classes against the plain reference
# ---------------------------------------------------------------------------

BANK = "data/boxNew_rgbd_templates.yml.gz"
GOLDEN = "tests/data/torch_cascade_golden.npz"
B = 4  # the cascade frames: templates 0, 1400 and 2000 planted, and a background
PLANTED = [0, 1383, 1400, 1983, 2000]  # 1383 and 1983 match between 92 and 94
THRS = [92.0, 94.0, 91.0, 95.0, 92.0, 94.0, 90.0, 93.0]
CIDS = [f"c{i}" for i in range(8)]


def _draw(i):
    """Class i's bank template ids: some of the planted templates and a
    seeded draw of the rest, a different count a class."""
    rng = np.random.default_rng(100 + i)
    keep = [t for t in PLANTED if rng.random() < 0.7] or [PLANTED[i % len(PLANTED)]]
    rest = rng.choice(2652, size=6 + 3 * i, replace=False).tolist()
    return sorted(set(keep) | set(rest))


DRAWS = [_draw(i) for i in range(8)]


@pytest.fixture(scope="module")
def banks():
    det = Detector.read(BANK, device="cpu")
    return det.bank(det.class_ids[0]), RB.read_templates(BANK)


@pytest.fixture(scope="module")
def frames():
    with np.load(GOLDEN) as g:
        rgb, dep = g["rgb"][:B], g["depth_mm"][:B]
    noisy = rgb + np.random.default_rng(0).normal(0.0, 16.0, rgb.shape)
    return np.clip(np.rint(noisy), 0, 255).astype(np.uint8), dep


@pytest.fixture(scope="module")
def reference(banks, frames):
    _, full = banks
    subs = [RB.Bank(full.class_id, full.T, full.modalities,
                    [[lv[i] for i in ids] for lv in full.levels],
                    [s[ids] for s in full.sizes], full.weak_threshold,
                    full.distance_threshold, full.difference_threshold) for ids in DRAWS]
    want = MultiClassReference(subs, THRS, 128, device="cpu").match(*frames)
    return [[RM.valid_set(w[c]) for w in want] for c in range(8)]


def _matcher(banks, **kw):
    bank, _ = banks
    det = Detector(bank.params, device="cpu")
    for cid, ids in zip(CIDS, DRAWS):
        det.attach_bank(TemplateBank(cid, bank.params, [bank.templates[i] for i in ids]))
    args = dict(pool_coarse=128 * B, pool_fine=96 * B, sel_row_cap=128)
    args.update(kw)
    return MultiClassBatchedMatcher(det, CIDS, THRS, B, top_k=128, fine_g=4,
                                    prune_mode="pooled", device="cpu", **args)


MATCHER_CASES = {"pools_hold": {}, "select_overflow": dict(sel_row_cap=1),
                 "coarse_overflow": dict(pool_coarse=1), "plain": dict(plain=True)}


@pytest.fixture(autouse=True)
def fresh_counters():
    tracing.reset()
    yield
    tracing.reset()


@pytest.mark.parametrize("case", list(MATCHER_CASES))
def test_eight_class_matcher_equals_the_reference_per_class(banks, frames, reference, case):
    assert len({len(d) for d in DRAWS}) == 8  # unequal template counts
    m = _matcher(banks, **MATCHER_CASES[case])
    got = m.match_batch(*frames)
    assert bool(m.last_pool.fallback) == (case in ("select_overflow", "coarse_overflow"))
    assert bool(m.last_pool.sel_overflow) == (case == "select_overflow")
    assert tracing.counters["multiclass.classes"] == 8
    for c, cid in enumerate(CIDS):
        host = {k: getattr(got[cid], k).numpy() for k in TM.Matches._fields}
        assert host["template_id"].shape == (B, 128)
        sets = [RM.valid_set({k: v[b] for k, v in host.items()}) for b in range(B)]
        assert sets == reference[c], (case, cid)
    assert all(sum(map(len, sets)) > 0 for sets in reference), "a class matched nothing"
    assert any(r != reference[0] for r in reference[1:])  # the classes differ


@pytest.mark.parametrize("case", ["pools_hold", "fine_overflow", "coarse_overflow"])
def test_fine_pool_counters_move_as_last_pool_says(banks, frames, case):
    kw = {"pools_hold": {}, "fine_overflow": dict(pool_fine=1),
          "coarse_overflow": dict(pool_coarse=1)}[case]
    m = _matcher(banks, **kw)
    fine_total, slots = 0, 0
    for _ in range(2):
        m.match_batch(*frames)
        st = m.last_pool
        if not bool(st.coarse_overflow):  # the fine stage ran
            fine_total += int(st.fine_total)
            slots += min(m.pool_fine, m.pool_coarse)
    assert tracing.counters.get("pool.fine_total", 0) == fine_total
    assert tracing.counters.get("pool.fine_slots", 0) == slots
    assert bool(m.last_pool.fine_overflow) == (case == "fine_overflow")
    if case == "coarse_overflow":
        assert slots == 0 and "pool.fine_slots" not in tracing.counters
    else:
        assert fine_total > 0
        assert tracing.counters["pool.coarse_slots"] == 2 * m.pool_coarse
