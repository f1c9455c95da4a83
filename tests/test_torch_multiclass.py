"""PyTorch port vs the JAX reference: the two-object path —
concat_level_features, match_pooled_multiclass (pooled, fine-pool
overflow, and the forced exhaustive fallbacks), merge_candidates_sorted,
split_matches_by_class and MultiClassBatchedMatcher(prune_mode="pooled").

The functions run on synthetic two-class banks built as
tests/test_multiclass.py builds them (random features, a random 120x160
scene); the matcher on two subsets of the committed RGB-D bank under two
class ids, over crops of the committed scenes.

Tolerance: exact equality of every output — every candidate and Matches
slot (sub-threshold filler and re-based ids included) and PooledStats.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _xdist_threads  # noqa: F401  (PyTorch threads per xdist worker)

from linemod_pose_estimation_tpu.models.detector import Detector as JDetector
from linemod_pose_estimation_tpu.models.serving import MultiClassBatchedMatcher as JMulti
from linemod_pose_estimation_tpu.models.templates import TemplateBank as JBank
from linemod_pose_estimation_tpu.ops import match as JM
from linemod_pose_estimation_tpu_torch import convert
from linemod_pose_estimation_tpu_torch.models.detector import Detector
from linemod_pose_estimation_tpu_torch.models.serving import MultiClassBatchedMatcher
from linemod_pose_estimation_tpu_torch.models.templates import TemplateBank
from linemod_pose_estimation_tpu_torch.ops import match as TM
from linemod_pose_estimation_tpu_torch.utils import scenes as S

T0, T1, E1, E0 = 5, 8, 24, 48
KC = (E1 - 1) // T1 + 1
H, W = 120, 160
HC, WC = (H // 2) // T1, (W // 2) // T1
TOP_K = 32
THRS = (85.0, 88.0)


def _bank(n, fmax, extent, seed):
    """(offsets, oris, live, count, size) of a random bank, as numpy."""
    rng = np.random.default_rng(seed)
    offs = rng.integers(0, extent, size=(n, fmax, 2)).astype(np.int32)
    oris = rng.integers(0, 8, size=(n, fmax)).astype(np.int32)
    return (offs, oris, np.ones((n, fmax), bool), np.full((n,), fmax, np.int32),
            np.full((n, 2), extent, np.int32))


def _both(fields):
    return (JM.LevelFeatures(*(jnp.asarray(a) for a in fields)),
            convert.level_features_from_numpy(*fields, device="cpu"))


def _assert_equal(got, want, what=""):
    for name, a, b in zip(want._fields, got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{what}{name}")


@pytest.fixture(scope="module")
def setup():
    """Two synthetic classes (different Fmax: the concat pads), both
    packages' merged banks and weights, and the scene's responses."""
    fA, fB = _bank(24, 14, E1, 0), _bank(40, 10, E1, 1)
    f0A, f0B = _bank(24, 14, E0, 2), _bank(40, 10, E0, 3)
    j1, t1 = zip(*(_both(f) for f in (fA, fB)))
    j0, t0 = zip(*(_both(f) for f in (f0A, f0B)))
    jf1, jbases = JM.concat_level_features(list(j1))
    jf0, _ = JM.concat_level_features(list(j0))
    tf1, tbases = TM.concat_level_features(list(t1))
    tf0, _ = TM.concat_level_features(list(t0))
    rgb = np.random.default_rng(7).integers(0, 255, size=(H, W, 3), dtype=np.uint8)
    pyr = JM.preprocess_frame(jnp.asarray(rgb), None, T0=T0, T1=T1, use_depth=False)
    R0, R1 = JM.stack_modalities(pyr, False)
    return dict(jf1=jf1, jf0=jf0, jbases=jbases, tf1=tf1, tf0=tf0, tbases=tbases,
                jR0=R0[None], jR1=R1[None],
                tR0=torch.from_numpy(np.array(R0))[None],
                tR1=torch.from_numpy(np.array(R1))[None])


def test_concat_level_features(setup):
    assert setup["tbases"] == setup["jbases"] == (0, 24)
    for key in ("f1", "f0"):
        _assert_equal(setup["t" + key], setup["j" + key], f"{key}.")


# (pool1, pool2, r_cap): pooled; fine pool overflow (the coarse pool is
# scored); coarse pool overflow and select-range overflow (each forces the
# exhaustive fallback)
POOLS = {"pooled": (256, 128, 256), "fine_overflow": (256, 2, 256),
         "coarse_overflow": (2, 2, 256), "select_overflow": (256, 128, 1)}


@pytest.mark.parametrize("case", list(POOLS))
def test_match_pooled_multiclass_merge_walk_split(setup, case):
    s = setup
    pool1, pool2, r_cap = POOLS[case]
    slices = ((0, 24), (24, 64))
    sel = tuple(t - 5.0 for t in THRS)
    out = {}
    for pkg, M, f1 in (("j", JM, s["jf1"]), ("t", TM, s["tf1"])):
        Wg = M.build_gemm_weights(f1, 8, T1, KC)
        Wc_ = M.build_cell_weights(f1, 8, T1, KC)
        Wf = M.build_cell_weights_fine(f1, 8, T1, KC, 4)
        if pkg == "t":
            Wg, Wc_, Wf = (TM.exact_weights(f1, 8, T1, KC), TM.MatmulWeight.from_nk(Wc_),
                           TM.MatmulWeight.from_nk(Wf))
        vpos = M.position_validity_flat(f1.size, T1, HC, WC)
        cands, nvs, stats = M.match_pooled_multiclass(
            s[pkg + "R1"], Wg, Wc_, Wf, f1.count, vpos, slices, sel, T1, KC, 4,
            pool1=pool1, pool2=pool2, top_k=TOP_K, Wc=WC, r_cap=r_cap)
        cat, nv = M.merge_candidates_sorted(cands)
        m = M.refine_candidates_opencv_batched(
            s[pkg + "R0"], s[pkg + "f0"], cat, T1, min(THRS), E0=E0, fine_T=T0, n_valid=nv)
        out[pkg] = (cands, nvs, stats, cat, nv, m, M.split_matches_by_class(m, slices, TOP_K))
    (jc, jn, js, jcat, jnv, jm, jsp), (tc, tn, ts, tcat, tnv, tm, tsp) = out["j"], out["t"]
    for i in range(2):
        _assert_equal(tc[i], jc[i], f"class {i} cands.")
        np.testing.assert_array_equal(tn[i].numpy(), np.asarray(jn[i]))
        _assert_equal(tsp[i], jsp[i], f"class {i} split.")
    _assert_equal(ts, js, "stats.")
    _assert_equal(tcat, jcat, "merged.")
    np.testing.assert_array_equal(tnv.numpy(), np.asarray(jnv))
    _assert_equal(tm, jm, "walk.")
    fallback = case in ("coarse_overflow", "select_overflow")
    assert bool(ts.fallback) == fallback
    assert bool(ts.fine_overflow) == (case == "fine_overflow")
    assert int(tsp[0].valid.sum()) + int(tsp[1].valid.sum()) > 0


def test_merge_and_split_ties():
    """Both classes hold the same candidates: every similarity ties across
    classes, so the merge's order and each class's split rest on the
    tie rule (the lower slot first, as the reference's top_k)."""
    rng = np.random.default_rng(3)
    Bq, Kq = 2, 8
    sim = np.round(rng.uniform(80, 95, size=(Bq, Kq)), 0).astype(np.float32)
    sim = -np.sort(-sim, axis=1)
    valid = sim >= 85
    fields = (rng.integers(0, 10, (Bq, Kq)).astype(np.int32),
              rng.integers(0, 5, (Bq, Kq)).astype(np.int32),
              rng.integers(0, 5, (Bq, Kq)).astype(np.int32), sim, valid)
    b_fields = (fields[0] + 10,) + fields[1:]
    jc = [JM.CoarseMatches(*(jnp.asarray(a) for a in f)) for f in (fields, b_fields)]
    tc = [convert.coarse_matches_from_numpy(*f, device="cpu") for f in (fields, b_fields)]
    jcat, jnv = JM.merge_candidates_sorted(jc)
    tcat, tnv = TM.merge_candidates_sorted(tc)
    _assert_equal(tcat, jcat)
    np.testing.assert_array_equal(tnv.numpy(), np.asarray(jnv))
    # walked matches of the merged slots: x numbers the slot, so the
    # split's order shows
    m = (np.concatenate([fields[0], b_fields[0]], 1),
         np.arange(2 * Kq, dtype=np.int32)[None].repeat(Bq, 0),
         np.zeros((Bq, 2 * Kq), np.int32), np.concatenate([sim, sim], 1),
         np.concatenate([valid, valid], 1))
    jm = JM.Matches(*(jnp.asarray(a) for a in m))
    tm = convert.matches_from_numpy(*m, device="cpu")
    for k in (4, 2 * Kq):
        for a, b in zip(TM.split_matches_by_class(tm, ((0, 10), (10, 20)), k),
                        JM.split_matches_by_class(jm, ((0, 10), (10, 20)), k)):
            _assert_equal(a, b)


# ---------------------------------------------------------------------------
# MultiClassBatchedMatcher on the committed bank
# ---------------------------------------------------------------------------

BANK = "data/boxNew_rgbd_templates.yml.gz"
CLASS_A = S.CROP_MATCHING[::2] + list(range(1, 2652, 211))
CLASS_B = S.CROP_MATCHING[1::2] + list(range(60, 2652, 173))



@pytest.fixture(scope="module")
def two_class_detectors():
    jb = JDetector.read(BANK)
    full = jb.bank(jb.class_ids[0])
    jd, td = JDetector(full.params), None
    for cid, ids in (("a", CLASS_A), ("b", CLASS_B)):
        sub = JBank(cid, full.params, [full.templates[i] for i in ids])
        jd.attach_bank(sub)
        if td is None:
            td = convert.detector_from_reference(sub, device="cpu")
        else:
            td.attach_bank(TemplateBank(cid, td.params,
                                        convert.templates_from_reference(sub.templates)))
    return jd, td


@pytest.mark.parametrize("pools", [(112, 72), (4, 4)])  # (4, 4): forced fallback
def test_multiclass_batched_matcher(two_class_detectors, pools):
    jd, td = two_class_detectors
    rgbs, deps = S.golden_crops()
    B = rgbs.shape[0]
    kw = dict(top_k=64, prune_mode="pooled", pool_coarse=pools[0], pool_fine=pools[1])
    jm = JMulti(jd, ["a", "b"], [70.0, 72.0], B, **kw)
    want = jm.match_batch(jnp.asarray(rgbs), jnp.asarray(deps))
    tm = MultiClassBatchedMatcher(td, ["a", "b"], [70.0, 72.0], B, device="cpu", **kw)
    got = tm.match_batch(rgbs, deps)
    assert list(got) == ["a", "b"]
    for cid in ("a", "b"):
        _assert_equal(got[cid], want[cid], f"{cid}.")
    _assert_equal(tm.last_pool, jm.last_pool, "stats.")
    assert bool(tm.last_pool.fallback) == (pools[0] == 4)
    assert int(got["a"].valid.sum()) > 0 and int(got["b"].valid.sum()) > 0


def test_multiclass_positions_mode_is_not_ported(two_class_detectors):
    """The default `positions` mode builds (tests/test_torch_prune_serving.py
    holds it to the reference); `two_axis`, which the reference's
    multi-class matcher does not have, raises."""
    _, td = two_class_detectors
    m = MultiClassBatchedMatcher(td, ["a", "b"], 70.0, 2, device="cpu")
    assert m.prune_mode == "positions" and m.fine_pos_cap == 128
    with pytest.raises(ValueError, match="two_axis"):
        MultiClassBatchedMatcher(td, ["a", "b"], 70.0, 2, prune_mode="two_axis",
                                 device="cpu")


@pytest.mark.slow
def test_two_object_golden_on_cpu():
    """The bench's two-object configuration on the cascade golden frames
    (tools/make_torch_window_golden.py): the 2652-template bank under two
    class ids at 92 / 94, pools 56 B / 36 B: each class's Matches and the
    PooledStats equal the JAX reference's."""
    with np.load("tests/data/torch_window_golden.npz") as z:
        gold = {k: z[k] for k in z.files}
    with np.load("tests/data/torch_cascade_golden.npz") as z:
        rgbs, deps = z["rgb"], z["depth_mm"]
    td = Detector.read(BANK, device="cpu")
    cid = td.class_ids[0]
    bank = td.bank(cid)
    td.attach_bank(TemplateBank(cid + "_second", bank.params, bank.templates))
    B = rgbs.shape[0]
    mc = MultiClassBatchedMatcher(td, [cid, cid + "_second"],
                                  list(gold["two_object_thresholds"]), B,
                                  top_k=int(gold["top_k"]), prune_mode="pooled",
                                  pool_coarse=56 * B, pool_fine=36 * B, device="cpu")
    out = mc.match_batch(rgbs, deps)
    for i, c in enumerate((cid, cid + "_second")):
        for name, a in out[c]._asdict().items():
            np.testing.assert_array_equal(a.numpy(), gold[f"mc{i}_{name}"],
                                          err_msg=f"{c}.{name}")
    for name, a in mc.last_pool._asdict().items():
        np.testing.assert_array_equal(a.numpy(), gold["mc_stats_" + name], err_msg=name)
    assert int(out[cid].valid.sum()) > 0
