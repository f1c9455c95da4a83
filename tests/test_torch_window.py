"""PyTorch port vs the JAX reference: kernel K5's plain version
(refine_scores_plain against the TPU kernel refine_scores_pallas, run in
interpret mode) and the five window refiners (refine_candidates,
_slices, _conv, _pallas, _pallas_batched), each against its own JAX
counterpart.

The cases cover contiguous and non-contiguous live feature slots,
anchors at and past the frame's bottom-right edge (reads fall outside
the frame), a flat response plateau (the last-maximum rule), offsets
equal to E0 - 1 (where every refiner agrees) and offsets past E0 (where
each keeps its own clip).

Tolerance: exact equality of every raw score and every Matches field.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linemod_pose_estimation_tpu.ops import match as JM
from linemod_pose_estimation_tpu.ops import pallas_kernels as PK
from linemod_pose_estimation_tpu_torch import convert
from linemod_pose_estimation_tpu_torch.ops import cuda_kernels as CK
from linemod_pose_estimation_tpu_torch.ops import match as TM

B, C, H, W = 2, 8, 96, 128
N, FMAX, E0, K = 10, 32, 40, 6
T0, T1 = 5, 8
WIN = 24
THR = 20.0
CASES = ["contiguous", "noncontiguous", "edge", "plateau", "past_e0"]


def _case(name: str, seed: int = 0):
    """(R0 (B, C, H, W) u8, bank fields, (B, K) candidate fields)."""
    rng = np.random.default_rng(seed)
    R0 = rng.integers(0, 5, size=(B, C, H, W)).astype(np.uint8)
    hi = E0 + 8 if name == "past_e0" else E0  # offsets in [0, hi)
    offs = rng.integers(0, hi, size=(N, FMAX, 2)).astype(np.int32)
    offs[:, 0] = E0 - 1  # every template has an offset of exactly E0 - 1
    oris = rng.integers(0, C, size=(N, FMAX)).astype(np.int32)
    if name == "noncontiguous":
        live = rng.random((N, FMAX)) < 0.7
    else:
        cnt = rng.integers(FMAX // 2, FMAX + 1, size=N)
        live = np.arange(FMAX)[None, :] < cnt[:, None]
    cnt = live.sum(1).astype(np.int32)
    size = rng.integers(20, E0, size=(N, 2)).astype(np.int32)
    if name == "plateau":  # flat responses: every in-frame window cell ties
        R0[0] = 2
    Hc, Wc = H // 2 // T1, W // 2 // T1
    tid = rng.integers(0, N, size=(B, K)).astype(np.int32)
    cy = rng.integers(0, Hc, size=(B, K)).astype(np.int32)
    cx = rng.integers(0, Wc, size=(B, K)).astype(np.int32)
    if name == "edge":  # the last cell, and cells whose anchors clip to H-1 / W-1
        cy[:, :3], cx[:, :3] = Hc - 1, Wc - 1
        cy[:, 3:], cx[:, 3:] = Hc + 2, Wc + 2
    sim = np.sort(rng.uniform(50, 100, size=(B, K)).astype(np.float32))[:, ::-1].copy()
    valid = rng.random((B, K)) < 0.7
    return R0, (offs, oris, live, cnt, size), (tid, cy, cx, sim, valid)


def _jax(R0, feats, cand):
    return (jnp.asarray(R0), JM.LevelFeatures(*(jnp.asarray(a) for a in feats)),
            JM.CoarseMatches(*(jnp.asarray(a) for a in cand)))


def _port(R0, feats, cand):
    return (torch.from_numpy(R0), convert.level_features_from_numpy(*feats),
            convert.coarse_matches_from_numpy(*cand))


def _frame(cand, b):
    return tuple(a[b] for a in cand)


def _assert_matches(got, want):
    for name, a, b in zip(want._fields, got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("name", ["noncontiguous", "edge"])
def test_refine_scores_plain_equals_tpu_kernel(name):
    """K5's plain version against the Pallas kernel itself (interpret
    mode), batched and single-frame, on the K5 operands the batched
    refiner builds (live slots compacted, offsets clipped to [0, E0])."""
    R0, feats, cand = _case(name)
    _, f0, c = _port(R0, feats, cand)
    plan = TM.window_plan(R0.shape, f0, c, T1, E0, T0)
    ops = [a.numpy() for a in plan.operands()]
    want = PK.refine_scores_pallas(jnp.asarray(R0), *(jnp.asarray(a) for a in ops),
                                   E0=E0, window=WIN, interpret=True,
                                   frame_idx=jnp.asarray(plan.frame_idx.numpy()))
    got = CK.refine_scores(torch.from_numpy(R0), *plan.operands(), window=WIN,
                           frame_idx=plan.frame_idx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.max()) > 0
    # single frame: (C, H, W) responses, no frame index
    k1 = slice(0, K)
    want1 = PK.refine_scores_pallas(jnp.asarray(R0[0]), *(jnp.asarray(a[k1]) for a in ops),
                                    E0=E0, window=WIN, interpret=True)
    got1 = CK.refine_scores_plain(torch.from_numpy(R0[0]), *(a[k1] for a in plan.operands()),
                                  window=WIN)
    np.testing.assert_array_equal(got1.numpy(), np.asarray(want1))


def test_refine_scores_plain_reads_zero_past_the_frame():
    """K5's plain version against a per-cell loop, with anchors at the
    bottom-right corner and slots past nf ignored."""
    rng = np.random.default_rng(5)
    Bq, Cq, Hq, Wq, Kq, Fq, win = 2, 3, 20, 22, 4, 6, 5
    R = rng.integers(0, 5, size=(Bq, Cq, Hq, Wq)).astype(np.uint8)
    oris = rng.integers(0, Cq, size=(Kq, Fq)).astype(np.int32)
    dys = rng.integers(0, 9, size=(Kq, Fq)).astype(np.int32)
    dxs = rng.integers(0, 9, size=(Kq, Fq)).astype(np.int32)
    nf = np.array([6, 3, 0, 5], np.int32)
    ay = np.array([Hq - 1, 4, 0, Hq - 6], np.int32)
    ax = np.array([Wq - 1, 2, 0, Wq - 3], np.int32)
    fr = np.array([1, 0, 1, 0], np.int32)
    got = CK.refine_scores(*(torch.from_numpy(a) for a in (R, oris, dys, dxs, nf, ay, ax)),
                           window=win, frame_idx=torch.from_numpy(fr)).numpy()
    want = np.zeros_like(got)
    for k in range(Kq):
        for wy in range(win):
            for wx in range(win):
                for f in range(nf[k]):
                    y, x = ay[k] + dys[k, f] + wy, ax[k] + dxs[k, f] + wx
                    if y < Hq and x < Wq:
                        want[k, wy, wx] += R[fr[k], oris[k, f], y, x]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", CASES)
def test_refine_candidates_pallas_batched(name):
    R0, feats, cand = _case(name)
    want = JM.refine_candidates_pallas_batched(*_jax(R0, feats, cand), T1, THR, E0,
                                               fine_T=T0, window=WIN, interpret=True)
    r, f0, c = _port(R0, feats, cand)
    got = TM.refine_candidates_pallas_batched(r, f0, c, T1, THR, E0, fine_T=T0, window=WIN)
    _assert_matches(got, want)
    assert got.valid.any()
    if name == "plateau":  # the last maximum: some window picks its bottom-right cell
        ay, ax = TM._window_anchors(c, T1, T0, H, W)
        assert bool(((got.x[0] - ax[0] == WIN - 1) & (got.y[0] - ay[0] == WIN - 1)).any())


@pytest.mark.parametrize("name", CASES)
def test_refine_candidates_pallas_single_frame(name):
    """The JAX single-frame K5 refiner has no interpret switch: hold the
    port's against the reference's batched one at B=1."""
    R0, feats, cand = _case(name)
    c1 = tuple(a[:1] for a in cand)
    want = JM.refine_candidates_pallas_batched(*_jax(R0[:1], feats, c1), T1, THR, E0,
                                               fine_T=T0, window=WIN, interpret=True)
    r, f0, c = _port(R0[0], feats, _frame(cand, 0))
    got = TM.refine_candidates_pallas(r, f0, c, T1, THR, E0, fine_T=T0, window=WIN)
    _assert_matches(got, type(want)(*(a[0] for a in want)))


@pytest.mark.parametrize("refiner", ["gather", "slices", "conv"])
@pytest.mark.parametrize("name", CASES)
def test_window_refiners_equal_their_reference(refiner, name):
    R0, feats, cand = _case(name)
    for b in range(B):
        jr, jf, jc = _jax(R0[b], feats, _frame(cand, b))
        tr, tf, tc = _port(R0[b], feats, _frame(cand, b))
        if refiner == "gather":
            want = JM.refine_candidates(jr, jf, jc, T1, THR, fine_T=T0, window=WIN)
            got = TM.refine_candidates(tr, tf, tc, T1, THR, fine_T=T0, window=WIN)
        elif refiner == "slices":
            want = JM.refine_candidates_slices(jr, jf, jc, T1, THR, E0, fine_T=T0, window=WIN)
            got = TM.refine_candidates_slices(tr, tf, tc, T1, THR, E0, fine_T=T0, window=WIN)
        else:
            want = JM.refine_candidates_conv(jr, jf, jc, T1, THR, E0, fine_T=T0, window=WIN)
            got = TM.refine_candidates_conv(tr, tf, tc, T1, THR, E0, fine_T=T0, window=WIN)
        _assert_matches(got, want)


def test_slices_anchor_min_y():
    R0, feats, cand = _case("contiguous", seed=2)
    jr, jf, jc = _jax(R0[0], feats, _frame(cand, 0))
    tr, tf, tc = _port(R0[0], feats, _frame(cand, 0))
    want = JM.refine_candidates_slices(jr, jf, jc, T1, THR, E0, fine_T=T0, window=WIN,
                                       anchor_min_y=30)
    got = TM.refine_candidates_slices(tr, tf, tc, T1, THR, E0, fine_T=T0, window=WIN,
                                      anchor_min_y=30)
    _assert_matches(got, want)
    assert int(got.y.min()) >= 30


@pytest.mark.parametrize("name", ["contiguous", "noncontiguous", "edge", "plateau"])
def test_refiners_agree_while_offsets_fit(name):
    """With every offset <= E0 - 1 (always true of a bank) the five
    refiners give the same Matches; past E0 their clips part them."""
    R0, feats, cand = _case(name)
    r, f0, c = _port(R0, feats, cand)
    batched = TM.refine_candidates_pallas_batched(r, f0, c, T1, THR, E0, fine_T=T0)
    for b in range(B):
        cb = TM.CoarseMatches(*(a[b] for a in c))
        ref = TM.Matches(*(a[b] for a in batched))
        for got in (TM.refine_candidates(r[b], f0, cb, T1, THR, fine_T=T0),
                    TM.refine_candidates_slices(r[b], f0, cb, T1, THR, E0, fine_T=T0),
                    TM.refine_candidates_conv(r[b], f0, cb, T1, THR, E0, fine_T=T0),
                    TM.refine_candidates_pallas(r[b], f0, cb, T1, THR, E0, fine_T=T0)):
            for x, y in zip(got, ref):
                assert torch.equal(x, y)
    R0, feats, cand = _case("past_e0")
    r, f0, c = _port(R0, feats, cand)
    cb = TM.CoarseMatches(*(a[0] for a in c))
    gather = TM.refine_candidates(r[0], f0, cb, T1, THR, fine_T=T0)
    conv = TM.refine_candidates_conv(r[0], f0, cb, T1, THR, E0, fine_T=T0)
    assert not all(torch.equal(x, y) for x, y in zip(gather, conv))
