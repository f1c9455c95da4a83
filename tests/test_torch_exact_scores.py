"""The exact coarse scorer's bank side and plain twin (ops/match.py's
feature table, ops/cuda_kernels.py's exact_scores_plain and the planes
kernel XS reads), on the synthetic banks of tests/test_prune.py, on CPU.

Every score is an integer sum, so the tolerance is exact equality with
the one-hot int8 GEMM the card no longer runs: over every cell of every
frame (int8_mm of _gemm_patches) and over a pool's row list (int8_mm of
_survivor_patches).  The kernel itself is held to the plain twin on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import sys

import numpy as np
import pytest
import torch

import _xdist_threads  # noqa: F401  (PyTorch threads per xdist worker)

sys.path.insert(0, "tests")
from test_prune import C, EXT, KC, T1, _bank, _frames  # noqa: E402

from linemod_pose_estimation_tpu_torch import convert  # noqa: E402
from linemod_pose_estimation_tpu_torch.ops import cuda_kernels as CK  # noqa: E402
from linemod_pose_estimation_tpu_torch.ops import match as TM  # noqa: E402
from linemod_pose_estimation_tpu_torch.ops import roofline as RL  # noqa: E402
from linemod_pose_estimation_tpu_torch.parallel.sharded_match import (  # noqa: E402
    pad_bank_features)


def _torch_bank(rng, n, **kw) -> TM.LevelFeatures:
    return convert.level_features_from_numpy(
        *(np.asarray(a) for a in _bank(rng, n, **kw)), device="cpu")


def _replace_rows(f: TM.LevelFeatures, **arrays) -> TM.LevelFeatures:
    f = f._replace(**{k: torch.as_tensor(v) for k, v in arrays.items()})
    return f._replace(count=f.live.sum(dim=1).to(torch.int32))


def _case(name: str):
    """(features, responses (B, C, H, W) u8, Kc) of one edge case."""
    rng = np.random.default_rng(11)
    Rb = torch.from_numpy(np.array(_frames(rng, b=2, sparse=0.4)))
    f = _torch_bank(rng, 24)
    Kc = KC
    if name == "duplicate_bins":
        # Slots 1-5 copy slot 0, and template 3 holds one bin 20 times: the
        # GEMM counts 6 and 20, the table keeps every copy.
        offs, oris, live = f.offsets.clone(), f.oris.clone(), f.live.clone()
        offs[:, 1:6], oris[:, 1:6], live[:, :6] = offs[:, :1], oris[:, :1], True
        offs[3, :20], oris[3, :20], live[3, :20] = offs[3, 0], oris[3, 0], True
        f = _replace_rows(f, offsets=offs, oris=oris, live=live)
    elif name == "beyond_clamp":
        # Offsets up to 2 * EXT: dy // T and dx // T reach past Kc - 1, so
        # the GEMM's row (and the table's) clamps the cell and keeps ry, rx.
        f = _replace_rows(f, offsets=torch.from_numpy(
            rng.integers(0, 2 * EXT, size=tuple(f.offsets.shape)).astype(np.int32)))
    elif name == "dead_slots":
        # Half the slots dead, template 0 with no live feature at all.
        live = torch.from_numpy(rng.random(tuple(f.live.shape)) < 0.5)
        live[0] = False
        f = _replace_rows(f, live=live)
    elif name == "tiled_dead_rows":
        # The bank tiled x3 and padded with dead rows to a multiple of 64,
        # as TemplateBank.tile pads the benchmark's bank.
        f = TM.LevelFeatures(*(torch.cat([a] * 3) for a in f))
        f = pad_bank_features(f, 64)
        assert int(f.live[-1].sum()) == 0
    elif name == "odd_frame":
        # A frame off the T grid (cropped to Hc*T x Wc*T) and Fmax 37.
        Rb = torch.from_numpy(rng.integers(0, 5, size=(3, C, 83, 101)).astype(np.uint8))
        f = _torch_bank(rng, 9, fmax=37, ext=30)
        Kc = (30 - 1) // T1 + 1
    else:
        assert name == "random"
    return f, Rb, Kc


CASES = ["random", "duplicate_bins", "beyond_clamp", "dead_slots", "tiled_dead_rows",
         "odd_frame"]


def _pool_rows(Rb, rng):
    """A pool-like row list: frame-major, positions scattered, some rows
    repeated, every frame's last cell included."""
    B, _, H, W = Rb.shape
    P = (H // T1) * (W // T1)
    frame = torch.from_numpy(np.sort(rng.integers(0, B, size=29)))
    pos = torch.from_numpy(rng.integers(0, P, size=29))
    frame = torch.cat([frame, frame[:3], torch.arange(B)])
    pos = torch.cat([pos, pos[:3], torch.full((B,), P - 1)])
    return frame, pos


@pytest.mark.parametrize("name", CASES)
def test_exact_scores_plain_equals_the_gemm(name):
    f, Rb, Kc = _case(name)
    B, _, H, W = Rb.shape
    P = (H // T1) * (W // T1)
    w = TM.exact_weights(f, C, T1, Kc)
    every = TM.int8_mm(TM._gemm_patches(Rb, T1, Kc), w.dense)
    got = CK.exact_scores_plain(Rb, w.table, T1, Kc)
    assert got.dtype == torch.int32 and torch.equal(got, every)
    assert torch.equal(CK.exact_scores(Rb, w.table, T1, Kc), every)  # CPU: the twin
    frame, pos = _pool_rows(Rb, np.random.default_rng(3))
    pooled = TM.int8_mm(TM._survivor_patches(Rb, frame, pos, T1, Kc), w.dense)
    assert torch.equal(CK.exact_scores_plain(Rb, w.table, T1, Kc, frame, pos), pooled)
    assert torch.equal(pooled, every[frame * P + pos])


@pytest.mark.parametrize("name", CASES)
def test_gemm_table_is_the_weights_nonzeros(name):
    f, _, Kc = _case(name)
    table = TM.build_gemm_table(f, C, T1, Kc)
    dense = TM.build_gemm_weights(f, C, T1, Kc).t()  # (N, K), K-major
    N = f.oris.shape[0]
    assert table.dtype == torch.int32 and table.shape[1] % 4 == 0
    assert table.shape[0] == dense.shape[0] == N
    for n in range(N):
        rows = table[n][table[n] >= 0].to(torch.int64)
        counts = torch.bincount(rows, minlength=dense.shape[1])
        assert torch.equal(counts, dense[n].to(torch.int64)), n
        assert int((table[n] >= 0).sum()) == int(f.count[n])
    # The table rebuilt from the dense weights holds the same entries.
    back = TM.gemm_table_from_nk(dense, N)
    srt = lambda t: torch.sort(torch.where(t >= 0, t, 2**31 - 1), dim=1).values
    width = min(back.shape[1], table.shape[1])
    assert torch.equal(srt(back)[:, :width], srt(table)[:, :width])
    assert bool((srt(back)[:, width:] == 2**31 - 1).all())
    assert bool((srt(table)[:, width:] == 2**31 - 1).all())


@pytest.mark.parametrize("name", ["bank_weights", "rows", "cpu_dense", "from_dense"])
def test_exact_weights(name):
    """ExactWeights, the exact scorer's one weights type: the bank builder
    holds exact_weights' weights; rows() scores as the sub-bank does; a
    CPU bank carries the dense operand, whose GEMM is the plain twin's
    sum; and the weights rebuilt from the dense counts score the same."""
    f, Rb, Kc = _case("dead_slots")
    w = TM.exact_weights(f, C, T1, Kc)
    assert w.n == w.table.shape[0] == f.oris.shape[0]
    frame, pos = _pool_rows(Rb, np.random.default_rng(5))
    if name == "bank_weights":
        bw = TM.build_bank_weights(f, C, T1, Kc, 4, group=8)
        assert bw.exact.n == w.n and torch.equal(bw.exact.table, w.table)
        assert torch.equal(bw.exact.dense.nk, w.dense.nk) and bw.exact.dense.n == w.n
    elif name == "rows":
        idx = torch.tensor([5, 0, 17, 5], dtype=torch.int32)
        sub = w.rows(idx)
        assert sub.n == 4 and torch.equal(sub.table, w.table[idx.long()])
        assert sub.dense.n == 4 and torch.equal(sub.dense.nk[:4], w.dense.nk[idx.long()])
        own = TM.exact_weights(TM.LevelFeatures(*(a[idx.long()] for a in f)), C, T1, Kc)
        raw = TM.coarse_scores_gemm_flat_batched_sub(Rb, w, idx, T1, Kc)
        assert torch.equal(raw, TM.coarse_scores_gemm_flat_batched(Rb, own, T1, Kc))
        assert torch.equal(TM.exact_scores(Rb, sub, T1, Kc, frame, pos),
                           CK.exact_scores_plain(Rb, own.table, T1, Kc, frame, pos))
    elif name == "cpu_dense":
        assert w.dense is not None and w.dense.n == w.n and w.dense.nk.shape[0] % 8 == 0
        for fr, po in ((None, None), (frame, pos)):
            want = CK.exact_scores_plain(Rb, w.table, T1, Kc, fr, po)
            for plain in (False, True):  # the CPU takes the GEMM either way
                assert torch.equal(TM.exact_scores(Rb, w, T1, Kc, fr, po, plain), want)
        assert int(want.max()) > 0
    else:
        back = TM.exact_weights_from_dense(w.dense.nk, w.n)
        assert back.n == w.n and torch.equal(back.dense.nk, w.dense.nk)
        srt = lambda t: torch.sort(torch.where(t >= 0, t, 2**31 - 1), dim=1).values
        width = back.table.shape[1]
        assert torch.equal(srt(back.table), srt(w.table)[:, :width])
        for fr, po in ((None, None), (frame, pos)):
            want = TM.exact_scores(Rb, w, T1, Kc, fr, po)
            assert torch.equal(TM.exact_scores(Rb, back, T1, Kc, fr, po), want)
            assert torch.equal(CK.exact_scores_plain(Rb, back.table, T1, Kc, fr, po), want)


@pytest.mark.parametrize("shape", [(2, 16, 160, 160), (1, 3, 83, 101), (2, 2, 240, 320)])
def test_exact_planes_are_the_linearized_responses(shape):
    rng = np.random.default_rng(2)
    Rb = torch.from_numpy(rng.integers(0, 5, size=shape).astype(np.uint8))
    B, C_, H, W = shape
    Hc, Wc = H // T1, W // T1
    g = CK.exact_geometry(Hc, Wc, KC, C_ * T1 * T1)
    planes = CK.exact_planes(Rb, T1, KC, g)
    assert planes.shape == (B, C_ * T1 * T1, g.Hp, g.XS)
    for b in range(B):
        lin = TM.linearize_responses(Rb[b], T1, KC)  # (L, Hc + Kc, Wc + Kc)
        assert torch.equal(planes[b, :, :Hc + KC - 1, :Wc + KC - 1],
                           lin[:, :Hc + KC - 1, :Wc + KC - 1])
    assert int(planes[:, :, Hc:].sum()) == 0 and int(planes[..., Wc:].sum()) == 0


@pytest.mark.parametrize("dims", [(30, 40, 12, 1024), (30, 40, 12, 400), (20, 20, 6, 1024),
                                  (1, 1, 1, 64), (7, 101, 3, 75), (60, 640, 12, 1024)])
def test_exact_geometry_holds_the_kernel_invariants(dims):
    Hc, Wc, Kc, L = dims
    g = CK.exact_geometry(Hc, Wc, Kc, L)
    segs = -(-Wc // 20)
    nbands = -(-Hc // g.BH)
    assert segs * g.BH <= 32 and g.BH >= 1 and (nbands - 1) * g.BH < Hc
    assert g.Hp == nbands * g.BH + Kc - 1 and g.XS % 8 == 0
    assert g.XS >= 4 * ((Kc - 1) // 4 + 5 * segs + 1) >= Wc + Kc - 1
    stage = g.LS * (g.BH + Kc - 1) * g.XS
    assert 1 <= g.LS <= L and stage <= CK.XS_STAGE_BYTES
    assert 2 * (-(-stage // 16) * 16) <= 227 * 1024
    if dims == (30, 40, 12, 1024):  # the benchmark's level 1: 2 bands of 15 rows
        assert g == CK.ExactGeometry(BH=15, Hp=41, XS=56, LS=79)
        banks = {(r * g.XS // 4 + s * 5) % 32 for r in range(g.BH) for s in range(segs)}
        assert len(banks) == g.BH * segs  # the warp's words in distinct banks


def test_exact_geometry_refuses_too_wide_a_frame():
    with pytest.raises(ValueError, match="cells a row"):
        CK.exact_geometry(10, 641, 12, 1024)


def test_exact_scores_bound():
    # The exhaustive call at the benchmark's shapes: B=32 x 1200 cells,
    # 10,624 templates of 126 live features (16 dead), Fmax 128.
    M_, N, F = 38_400, 10_624, 128
    live = 10_608 * 126
    b = RL.exact_scores(M_, N, F, live, 32 * 16 * 240 * 320)
    assert b.ops == M_ * live and b.by == "operations"
    assert b.bytes == 32 * 16 * 240 * 320 + N * F * 4 + M_ * N * 4
    assert b.ms == pytest.approx(M_ * live / 67e9)
    pool = RL.exact_scores(1152, N, F, live, 1152 * 147_456)
    assert pool.bytes == 1152 * 147_456 + N * F * 4 + 1152 * N * 4
