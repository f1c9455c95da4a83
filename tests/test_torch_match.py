"""PyTorch port vs the JAX reference: the pooled exact matcher
(match_pooled_fine_with_fallback and its stages) on the synthetic banks
of tests/test_prune.py, on CPU.

Tolerance: exact equality of every output — candidate ids, cells and
order (sub-threshold filler slots included), f32 similarities (the same
expression in the same order), valid masks, n_valid and PooledStats.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")
from test_prune import C, KC, T1, _bank, _frames, _plant  # noqa: E402

from linemod_pose_estimation_tpu.ops import match as JM  # noqa: E402
from linemod_pose_estimation_tpu_torch import convert  # noqa: E402
from linemod_pose_estimation_tpu_torch.ops import match as TM  # noqa: E402

G = 4


def _scene(case):
    rng = np.random.default_rng(11)
    n = 48
    feats = _bank(rng, n)
    if case == "busy":
        # frame 1 carries many planted objects, frame 2 is empty
        Rb = np.zeros((3, C, 160, 160), np.uint8)
        Rb = _plant(Rb, feats, 5, 0, 3, 3)
        for i in range(28):
            Rb = _plant(Rb, feats, i, 1, 2 * (i % 7), 2 * (i // 7))
    else:
        Rb = np.array(_frames(rng, b=3))
        for b, (tid, py, px) in enumerate([(3, 2, 4), (10, 7, 9)]):
            Rb = _plant(Rb, feats, tid, b, py, px)
        Rb[2] = 0  # an empty frame
    return feats, Rb


# (scene, pool1, pool2, r_cap, group, what the case exercises)
CASES = {
    "pooled": ("sparse", 1024, 512, 128, None),
    "grouped": ("sparse", 1024, 512, 128, 8),
    "busy_shared_pool": ("busy", 96, 96, 96, None),
    "coarse_overflow_fallback": ("busy", 8, 8, 64, None),
    "fine_overflow": ("busy", 1024, 4, 128, 8),
    "select_cap_fallback": ("busy", 256, 256, 4, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_pooled_matcher_equals_reference(case):
    scene, pool1, pool2, r_cap, group = CASES[case]
    feats, Rb = _scene(scene)
    thr, top_k = 85.0, 32
    Hc, Wc = Rb.shape[2] // T1, Rb.shape[3] // T1
    vpos = JM.position_validity_flat(feats.size, T1, Hc, Wc)
    Wg = JM.build_gemm_weights(feats, C, T1, KC)
    Wcell = JM.build_cell_weights(feats, C, T1, KC)
    Wf = JM.build_cell_weights_fine(feats, C, T1, KC, G)
    gkw, gargs = {}, (None, None)
    if group:
        gargs = JM.build_group_bound(feats, C, T1, KC, group, W_cell=Wcell)
        gkw = dict(W_group=gargs[0], group_counts=gargs[1], pool0=2 * pool1,
                   group=group)
    cands, n_valid, stats = JM.match_pooled_fine_with_fallback(
        jnp.asarray(Rb), Wg, Wcell, Wf, feats.count, vpos, thr, T1, KC, G,
        pool1, pool2, top_k, Wc, r_cap=r_cap, **gkw)

    w = convert.bank_from_numpy(Wg, Wcell, Wf, *gargs)
    tf = convert.level_features_from_numpy(*(np.asarray(a) for a in feats))
    tkw = {}
    if group:
        tkw = dict(W_group=w.W_group, group_counts=w.group_counts,
                   pool0=2 * pool1, group=group)
    tvpos = TM.position_validity_flat(tf.size, T1, Hc, Wc)
    np.testing.assert_array_equal(tvpos.numpy(), np.asarray(vpos))
    got, got_nv, got_stats = TM.match_pooled_fine_with_fallback(
        torch.from_numpy(Rb), w.W_gemm, w.W_cell, w.W_fine, tf.count, tvpos,
        thr, T1, KC, G, pool1, pool2, top_k, Wc, r_cap=r_cap, **tkw)

    for name, a, b in zip(cands._fields, got, cands):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    np.testing.assert_array_equal(got_nv.numpy(), np.asarray(n_valid))
    for name, a, b in zip(stats._fields, got_stats, stats):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert int(got_nv.sum()) > 0  # the scene must yield candidates
    expect_fallback = case in ("coarse_overflow_fallback", "select_cap_fallback")
    assert bool(got_stats.fallback) == expect_fallback
    if case == "fine_overflow":
        assert bool(got_stats.fine_overflow)


def test_compaction_and_window_gather_equal_reference():
    rng = np.random.default_rng(3)
    for cap in (5, 40):
        elig = rng.random(100) < 0.2
        i, k, t = JM._compact_eligible_flat(jnp.asarray(elig), cap)
        ti, tk, tt = TM._compact_eligible_flat(torch.from_numpy(elig), cap)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(i))
        np.testing.assert_array_equal(tk.numpy(), np.asarray(k))
        assert int(tt) == int(t)
    L = rng.integers(0, 5, size=(3 * 10, 12, 16)).astype(np.int8)
    frame = rng.integers(0, 3, size=17)
    row0 = frame * 10 + rng.integers(0, 7, size=17)
    col0 = rng.integers(0, 9, size=17)
    want = JM.gather_windows_pooled(jnp.asarray(L), jnp.asarray(row0, jnp.int32),
                                    jnp.asarray(col0, jnp.int32), 4)
    got = TM.gather_windows_pooled(torch.from_numpy(L), torch.from_numpy(row0),
                                   torch.from_numpy(col0), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_thresholds_and_exhaustive_select_equal_reference():
    """int_score_threshold bit-for-bit (f32 expression order), and the
    exhaustive select's order under ties (lower flat index first)."""
    rng = np.random.default_rng(5)
    tf = rng.integers(0, 200, size=64).astype(np.int32)
    for thr in (86.0, 85.0, 77.7):
        want = np.asarray(JM.int_score_threshold(jnp.float32(thr), jnp.asarray(tf)))
        got = TM.int_score_threshold(thr, torch.from_numpy(tf)).numpy()
        np.testing.assert_array_equal(got, want)
    raw = rng.integers(0, 6, size=(2, 30, 16)).astype(np.int32)  # many ties
    cnt = np.full(16, 2, np.int32)
    vpos = rng.random((30, 16)) < 0.8
    want = [JM.select_candidates_flat(jnp.asarray(raw[b]), jnp.asarray(cnt),
                                      jnp.asarray(vpos), 50.0, 40, 6, exact=True)
            for b in range(2)]
    got = TM.select_candidates_flat(torch.from_numpy(raw), torch.from_numpy(cnt),
                                    torch.from_numpy(vpos), 50.0, 40, 6)
    for b in range(2):
        for name, a, w in zip(got._fields, got, want[b]):
            np.testing.assert_array_equal(a[b].numpy(), np.asarray(w), err_msg=name)
