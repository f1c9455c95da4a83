"""PyTorch port vs the JAX reference: cv::linemod's exact local walk
(refine_candidates_opencv_batched; kernel K3's plain version on CPU).

Tolerance: exact equality of every Matches field (ids, positions, the
f32 similarity — same expression, same order — and valid).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linemod_pose_estimation_tpu.ops import match as JM
from linemod_pose_estimation_tpu_torch import convert
from linemod_pose_estimation_tpu_torch.ops import cuda_kernels as CK
from linemod_pose_estimation_tpu_torch.ops import match as TM

B, C, H, W = 2, 16, 120, 160
N, FMAX, E0, K = 12, 24, 40, 10
T0, T1 = 5, 8


def _case(contiguous_live: bool, seed: int = 0, fmax: int = FMAX):
    rng = np.random.default_rng(seed)
    R0 = rng.integers(0, 5, size=(B, C, H, W)).astype(np.uint8)
    offs = rng.integers(0, E0 + 4, size=(N, fmax, 2)).astype(np.int32)  # some > E0
    oris = rng.integers(0, C, size=(N, fmax)).astype(np.int32)
    if contiguous_live:
        cnt = rng.integers(fmax // 2, fmax + 1, size=N).astype(np.int32)
        live = np.arange(fmax)[None, :] < cnt[:, None]
    else:
        live = rng.random((N, fmax)) < 0.7
        cnt = live.sum(1).astype(np.int32)
    size = rng.integers(20, E0, size=(N, 2)).astype(np.int32)
    feats = (offs, oris, live, cnt, size)
    # candidates: cells spread over the level-1 grid, including both borders
    Hc, Wc = H // 2 // T1, W // 2 // T1
    tid = rng.integers(0, N, size=(B, K)).astype(np.int32)
    cy = rng.integers(0, Hc, size=(B, K)).astype(np.int32)
    cx = rng.integers(0, Wc, size=(B, K)).astype(np.int32)
    cy[:, 0], cx[:, 0] = 0, 0
    cy[:, 1], cx[:, 1] = Hc - 1, Wc - 1
    sim = np.sort(rng.uniform(50, 100, size=(B, K)).astype(np.float32))[:, ::-1].copy()
    valid = np.zeros((B, K), bool)
    valid[0, :6] = True             # a valid prefix of 6
    valid[1, [0, 1, 4, 7]] = True   # NOT a prefix: the guard walks all slots
    cand = (tid, cy, cx, sim, valid)
    n_valid = valid.sum(1).astype(np.int32)
    return R0, feats, cand, n_valid


def _odd_case(name: str):
    """The walk plans K3 is held to on the card (utils/kernel_cases.py),
    built at the matcher's level so that the JAX reference sees them too."""
    R0, feats, cand, n_valid = _case(False, seed=2, fmax=300 if name == "F300" else FMAX)
    offs, oris, live, cnt, size = feats
    tid, cy, cx, sim, valid = cand
    if name == "n_valid_0":  # frame 1 has no valid candidate: nothing walked
        valid[1] = False
        n_valid = valid.sum(1).astype(np.int32)
    elif name == "dead_slot":  # a walked slot whose template has no live feature
        live[3] = False
        cnt[3] = 0
        tid[0, :3] = 3
        tid[1, 0] = 3
    elif name == "corner_E0":  # the bottom-right grid corner, offsets at E0
        cy[:] = H // 2 // T1 - 1 - (np.arange(K) % 2)
        cx[:] = W // 2 // T1 - 1 - (np.arange(K) // 2 % 2)
        offs[:, ::3] = E0
        offs[:, 1::3, 0] = E0
        size[:] = 20
    return R0, feats, cand, n_valid


def _walk_both(R0, feats, cand, thr, nv):
    want = JM.refine_candidates_opencv_batched(
        jnp.asarray(R0), JM.LevelFeatures(*(jnp.asarray(a) for a in feats)),
        JM.CoarseMatches(*(jnp.asarray(a) for a in cand)), T1, thr, E0,
        fine_T=T0, n_valid=None if nv is None else jnp.asarray(nv))
    got = TM.refine_candidates_opencv_batched(
        torch.from_numpy(R0), convert.level_features_from_numpy(*feats, device="cpu"),
        TM.CoarseMatches(*(torch.from_numpy(a) for a in cand)), T1, thr, E0,
        fine_T=T0, n_valid=None if nv is None else torch.from_numpy(nv))
    for name, a, b in zip(want._fields, got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    return got


@pytest.mark.parametrize("contiguous_live", [True, False])
@pytest.mark.parametrize("with_n_valid", [True, False])
def test_walk_equals_reference(contiguous_live, with_n_valid):
    R0, feats, cand, n_valid = _case(contiguous_live)
    got = _walk_both(R0, feats, cand, 30.0, n_valid if with_n_valid else None)
    assert got.valid.any() and (got.similarity > 0).any()


@pytest.mark.parametrize("name", ["n_valid_0", "dead_slot", "F300", "corner_E0"])
def test_walk_odd_plans_equal_reference(name):
    """Every Matches field equal to the JAX reference's on the odd walk
    plans: a frame with n_valid = 0, walked slots whose features are all
    dead, F = 300 (past one 256-feature round of K3's staging), and
    candidates at the bottom-right grid corner with offsets at E0."""
    R0, feats, cand, n_valid = _odd_case(name)
    got = _walk_both(R0, feats, cand, 30.0, n_valid)
    assert got.valid.any()
    if name == "n_valid_0":
        assert not got.valid[1].any() and not (got.similarity[1] > 0).any()
    if name == "dead_slot":
        assert (got.similarity[0, :3] == 0).all() and not got.valid[0, :3].any()


def test_walk_scores_plain_skips_dead_slots_and_reads_zero_outside():
    """Direct check of K3's plain version against a per-placement loop:
    slots k >= n_valid[b] are exactly 0, reads past the frame count 0."""
    rng = np.random.default_rng(4)
    Bq, Cq, Hq, Wq, Kq, Fq, T = 2, 3, 30, 34, 3, 5, 2
    R0 = rng.integers(0, 5, size=(Bq, Cq, Hq, Wq)).astype(np.uint8)
    oris = rng.integers(0, Cq, size=(Bq, Kq, Fq)).astype(np.int32)
    dys = rng.integers(0, 9, size=(Bq, Kq, Fq)).astype(np.int32)
    dxs = rng.integers(0, 9, size=(Bq, Kq, Fq)).astype(np.int32)
    live = rng.random((Bq, Kq, Fq)) < 0.8
    gy0 = rng.integers(0, 10, size=(Bq, Kq)).astype(np.int32)
    gx0 = rng.integers(0, 10, size=(Bq, Kq)).astype(np.int32)
    nv = np.array([3, 1], np.int32)
    got = CK.walk_scores(*(torch.from_numpy(a) for a in
                           (R0, oris, dys, dxs, live, gy0, gx0, nv)), T).numpy()
    want = np.zeros_like(got)
    for b in range(Bq):
        for k in range(nv[b]):
            for r in range(16):
                for c in range(16):
                    for f in range(Fq):
                        y = (gy0[b, k] + r) * T + dys[b, k, f]
                        x = (gx0[b, k] + c) * T + dxs[b, k, f]
                        if live[b, k, f] and y < Hq and x < Wq:
                            want[b, k, r, c] += R0[b, oris[b, k, f], y, x]
    np.testing.assert_array_equal(got, want)
