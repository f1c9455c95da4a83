"""The CUDA kernels K1, K2 (also at B=1, the port of K2b), K3, K4, K5, DN,
XS, TK, BM and the kernel paths of BatchedMatcher (pooled, positions, two_axis, the
RGB-only bank), the K5 refiner, MultiClassBatchedMatcher (pooled and its
default mode) and DetectionPipeline against their plain
PyTorch versions, on a card; then the cascade's non-default options (the
ICP variants, scene normals, the in-plane sweep, the local-descriptor pose,
detect in six configurations) on the card against the CPU and the golden;
then the serving surface: K4 at template_refinement's launch against
plain, PipelinedRunner against blocking calls, PoseService against the
serving golden; then Detector(engine="gather") and the coarse engines
against the cascade golden, and the grasp planner, the segmentation ops
and the aux filters against the aux golden; then the multi-device steps
(parallel/sharded_match.py) in 4 gloo ranks on the card, kernel paths
against plain paths.  Every test here is
marked requires_cuda and skips without a CUDA device; the file imports no
JAX, so it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: bitwise equality (every output is an integer, bool, or the
same f32 expression); detect's Matches equal the committed JAX golden.
"""

import numpy as np
import pytest
import torch

from linemod_pose_estimation_tpu_torch.models.detector import Detector
from linemod_pose_estimation_tpu_torch.models.pipeline import DetectionPipeline
from linemod_pose_estimation_tpu_torch.models.renderer import _pad_triangles
from linemod_pose_estimation_tpu_torch.models.serving import (
    BatchedMatcher, MultiClassBatchedMatcher, slice_settings)
from linemod_pose_estimation_tpu_torch.models.templates import TemplateBank
from linemod_pose_estimation_tpu_torch.ops import cuda_kernels as CK
from linemod_pose_estimation_tpu_torch.ops import cuda_preprocess as CP
from linemod_pose_estimation_tpu_torch.ops import features as TF
from linemod_pose_estimation_tpu_torch.ops import match as TM
from linemod_pose_estimation_tpu_torch.ops import raster as RA
from linemod_pose_estimation_tpu_torch.utils import kernel_cases as KC
from linemod_pose_estimation_tpu_torch.utils import pointcloud as TP
from linemod_pose_estimation_tpu_torch.utils import scenes as S
from linemod_pose_estimation_tpu_torch.utils import tracing

BANK = "data/boxNew_rgbd_templates.yml.gz"
PARAMS = "data/boxNew_rgbd_params.yml.gz"
CASCADE_GOLDEN = "tests/data/torch_cascade_golden.npz"
SERVING_GOLDEN = "tests/data/torch_serving_golden.npz"
RGB_BANK = "data/boxNew_full_templates.yml.gz"
RGB_PARAMS = "data/boxNew_full_params.yml.gz"



@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("level", [0, 1])
def test_quantize_cg_kernel_equals_plain(cuda, level):
    rng = np.random.default_rng(level)
    rgb = torch.from_numpy(rng.integers(0, 256, size=(4, 480, 640, 3)).astype(np.uint8))
    rgb[1, :, :300] = torch.tensor([200, 40, 40], dtype=torch.uint8)
    rgb = rgb.to(cuda)
    if level:
        rgb = torch.stack([TF.pyr_down(rgb[..., c].float()) for c in range(3)], -1)
    got = CP.quantize_color_gradient(rgb.contiguous(), 10.0)
    assert torch.equal(got, CP.quantize_color_gradient_plain(rgb, 10.0))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("T", [5, 8])
def test_spread_response_kernel_equals_plain(cuda, T):
    g = torch.Generator(device=cuda).manual_seed(T)
    q = (1 << torch.randint(0, 8, (4, 480, 640), device=cuda, generator=g)).to(torch.uint8)
    q = q * (torch.rand((4, 480, 640), device=cuda, generator=g) < 0.3)
    assert torch.equal(CK.spread_response(q, T), CK.spread_response_plain(q, T))


ODD_SHAPES = [(1, 7), (7, 13), (3, 3), (1, 1), (37, 131), (65, 249), (480, 643)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape", ODD_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_preprocess_kernels_on_odd_shapes(cuda, shape):
    """K1 (u8 and f32 input) and K2 (T=5 and 8) against their plain
    versions on shapes off the kernels' tiles: widths that are not a
    multiple of K1's 92 output columns nor of K2's 4 pixels, 1- and 7-row
    frames, 1x1 and 3x3 frames."""
    H, W = shape
    g = torch.Generator(device=cuda).manual_seed(H * 1000 + W)
    rgb = torch.randint(0, 256, (2, H, W, 3), device=cuda, generator=g, dtype=torch.uint8)
    yy = torch.arange(H, device=cuda)[:, None].float()
    xx = torch.arange(W, device=cuda)[None, :].float()
    rgb[1, ..., 0] = ((torch.sin(yy / 3.0) + torch.cos(xx / 4.0)) * 60 + 128).to(torch.uint8)
    for x in (rgb, rgb.float()):
        assert torch.equal(CP.quantize_color_gradient(x, 10.0),
                           CP.quantize_color_gradient_plain(x, 10.0))
    q = (1 << torch.randint(0, 8, (2, H, W), device=cuda, generator=g)).to(torch.uint8)
    q = q * (torch.rand((2, H, W), device=cuda, generator=g) < 0.3)
    for T in (5, 8):
        assert torch.equal(CK.spread_response(q, T), CK.spread_response_plain(q, T))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("W", [640, 321])
def test_spread_response_channel_offset_write(cuda, B, W):
    """K2 writing into channels [c, c + 8) of a wider stack equals its
    plain version there and leaves every other channel's bytes alone."""
    g = torch.Generator(device=cuda).manual_seed(B)
    q = (1 << torch.randint(0, 8, (B, 48, W), device=cuda, generator=g)).to(torch.uint8)
    q = q * (torch.rand((B, 48, W), device=cuda, generator=g) < 0.3)
    for T, c in ((5, 0), (8, 8), (5, 3)):
        stack = torch.full((B, 19, 48, W), 0xAB, dtype=torch.uint8, device=cuda)
        got = CK.spread_response(q, T, out=stack, channel=c)
        assert got.data_ptr() == stack[:, c].data_ptr()
        assert torch.equal(stack[:, c:c + 8], CK.spread_response_plain(q, T))
        rest = torch.cat([stack[:, :c], stack[:, c + 8:]], dim=1)
        assert bool((rest == 0xAB).all())


@pytest.mark.requires_cuda
def test_walk_kernel_equals_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    B, K, F, C = 4, 128, 128, 16
    ri = lambda hi, shape: torch.randint(0, hi, shape, device=cuda, generator=g,
                                         dtype=torch.int32)
    R0 = ri(5, (B, C, 480, 640)).to(torch.uint8)
    args = (R0, ri(C, (B, K, F)), ri(193, (B, K, F)), ri(193, (B, K, F)),
            torch.rand((B, K, F), device=cuda, generator=g) < 0.9,
            ri(90, (B, K)), ri(125, (B, K)),
            torch.tensor([128, 50, 0, 7], dtype=torch.int32, device=cuda))
    assert torch.equal(CK.walk_scores(*args, 5), CK.walk_scores_plain(*args, 5))


@pytest.fixture(scope="module")
def odd_walks():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return KC.walk_cases(torch.device("cuda"))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", ["n_valid_0", "dead_slot", "F37", "F300", "edges",
                                  "B1_K512", "T4"])
def test_walk_kernel_on_odd_plans(odd_walks, name):
    """K3 against its plain version on the odd plans chip_smoke holds it
    to (utils/kernel_cases.py): frames with n_valid = 0, walked slots with
    every feature dead, F = 37 and 300, placements past the frame's edges,
    B = 1 at K = 512, T = 4."""
    R0, ops, T = odd_walks[name]
    got = CK.walk_scores(R0, *ops, T)
    assert torch.equal(got, CK.walk_scores_plain(R0, *ops, T))
    if name == "n_valid_0":
        assert not bool(got[1].any()) and not bool(got[3].any())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("batched", [True, False])
def test_refine_scores_kernel_equals_plain(cuda, batched):
    """K5 at the K5 chain's widths (24 x 24 window, Fmax 128, C=16
    480x640), anchors over the frame and at its bottom-right edge, ragged
    nf (0 and a full row included)."""
    g = torch.Generator(device=cuda).manual_seed(1)
    B, K, F, C, H, W = (4, 512, 128, 16, 480, 640) if batched else (1, 256, 128, 16, 480, 640)
    ri = lambda lo, hi, shape: torch.randint(lo, hi, shape, device=cuda, generator=g,
                                             dtype=torch.int32)
    R = ri(0, 5, (B, C, H, W)).to(torch.uint8)
    nf = ri(0, F + 1, (K,))
    nf[:2] = torch.tensor([0, F], dtype=torch.int32)
    ay, ax = ri(0, H, (K,)), ri(0, W, (K,))
    ay[K // 2:], ax[K // 2:] = ri(H - 24, H, (K - K // 2,)), ri(W - 24, W, (K - K // 2,))
    args = (ri(0, C, (K, F)), ri(0, 193, (K, F)), ri(0, 193, (K, F)), nf, ay, ax)
    if batched:
        fr = ri(0, B, (K,))
        got = CK.refine_scores(R, *args, window=24, frame_idx=fr)
        want = CK.refine_scores_plain(R, *args, window=24, frame_idx=fr)
    else:
        got = CK.refine_scores(R[0], *args, window=24)
        want = CK.refine_scores_plain(R[0], *args, window=24)
    assert torch.equal(got, want) and int(got.max()) > 0


@pytest.fixture(scope="module")
def odd_windows():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return KC.window_cases(torch.device("cuda"))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", KC.WINDOW_CASES)
def test_refine_scores_kernel_on_odd_cases(odd_windows, name):
    """K5 against its plain version on the odd cases chip_smoke holds it
    to (utils/kernel_cases.py): windows of 1, 7, 24 and 40, F = 37 and 300
    with responses up to 255, nf of 0 and above F, W = 643, windows over
    every edge of the frame, a (C, H, W) input, odd data pointers."""
    R, ops, window, frame = odd_windows[name]
    got = CK.refine_scores(R, *ops, window=window, frame_idx=frame)
    assert torch.equal(got, CK.refine_scores_plain(R, *ops, window=window, frame_idx=frame))
    assert int(got.max()) > 0


@pytest.mark.requires_cuda
def test_refine_scores_kernel_window_40_at_full_width(cuda):
    """K5 at a 40 x 40 window on a 480x640, C=16 batch, on an odd data
    pointer: two row segments a window row, two tiles a candidate."""
    g = torch.Generator(device=cuda).manual_seed(2)
    B, K, F, C, H, W = 2, 256, 128, 16, 480, 640
    ri = lambda lo, hi, shape: torch.randint(lo, hi, shape, device=cuda, generator=g,
                                             dtype=torch.int32)
    n = B * C * H * W
    R = torch.empty(n + 8, dtype=torch.uint8, device=cuda)[1:n + 1].view(B, C, H, W)
    R.copy_(ri(0, 5, (B, C, H, W)))
    args = (ri(0, C, (K, F)), ri(0, 193, (K, F)), ri(0, 193, (K, F)), ri(0, F + 1, (K,)),
            ri(0, H, (K,)), ri(0, W, (K,)))
    fr = ri(0, B, (K,))
    got = CK.refine_scores(R, *args, window=40, frame_idx=fr)
    assert torch.equal(got, CK.refine_scores_plain(R, *args, window=40, frame_idx=fr))


@pytest.mark.requires_cuda
def test_batched_matcher_kernels_equal_plain(cuda):
    td = Detector.read(BANK)
    cid = td.class_ids[0]
    B = 2
    kw = dict(top_k=64, prune=True, prune_mode="pooled", fine_g=4,
              group_bound=16, pool_coarse=56 * B, pool_fine=36 * B,
              pool_group=B * 15 * 20, device=cuda)
    rgbs, deps = S.golden_crops()
    got = BatchedMatcher(td, cid, 70.0, B, **kw).match_batch(rgbs, deps)
    want = BatchedMatcher(td, cid, 70.0, B, plain=True, **kw).match_batch(rgbs, deps)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _fullbin_operands(cuda):
    """batch32-fullbin's exact-scorer operands: the B=32 level-1 responses
    of S.bin_picking_batch's scenes (16 x 240 x 320, Kc 12) and the bank
    tiled to 10,624 templates (16 of them dead rows): its feature table,
    and its dense one-hot operand built here for the int8 GEMM route
    (the card's exact weights hold none)."""
    td = Detector.read(BANK)
    bank = td.bank(td.class_ids[0])
    tiled = bank.tile(-(-10240 // bank.num_templates), 10624)
    C, Kc = 8 * tiled.num_modalities, tiled.max_cell_extent(1)
    f1 = tiled.merged_features(1).to(cuda)
    w = TM.exact_weights(f1, C, 8, Kc)
    assert w.dense is None
    dense = TM.MatmulWeight.from_kn(TM.build_gemm_weights(f1, C, 8, Kc))
    rgbs, deps, _ = S.bin_picking_batch(32, seed=3)
    _, R1 = TM.preprocess_frames_batched(torch.from_numpy(rgbs).to(cuda),
                                         torch.from_numpy(deps).to(cuda), use_depth=True)
    return R1, w.table, dense, Kc


@pytest.mark.requires_cuda
@pytest.mark.parametrize("rows", ["every_cell", "pool_1152"])
def test_exact_scores_kernel_at_the_fullbin_shapes(cuda, rows):
    """XS against its plain twin and the int8 GEMM route it replaced, at
    batch32-fullbin's shapes: all 38,400 cells of the batch (the
    exhaustive call) or a frame-major 1152-row pool list (the exact tier's
    36 rows a frame), over 10,624 templates; bit for bit."""
    R1, table, dense, Kc = _fullbin_operands(cuda)
    B, _, H, Wd = R1.shape
    P = (H // 8) * (Wd // 8)
    tracing.reset()
    if rows == "every_cell":
        got = CK.exact_scores(R1, table, 8, Kc)
        gemm = TM.int8_mm(TM._gemm_patches(R1, 8, Kc), dense)
        frame = pos = None
    else:
        g = torch.Generator().manual_seed(21)
        frame = torch.sort(torch.randint(0, B, (1152,), generator=g)).values.to(cuda)
        pos = torch.randint(0, P, (1152,), generator=g).to(cuda)
        got = CK.exact_scores(R1, table, 8, Kc, frame, pos)
        gemm = TM.int8_mm(TM._survivor_patches(R1, frame, pos, 8, Kc), dense)
    assert tracing.launches()["exact_scores"] == 1
    assert got.shape == gemm.shape == (gemm.shape[0], 10624)
    assert torch.equal(got, gemm)
    del gemm
    assert torch.equal(got, CK.exact_scores_plain(R1, table, 8, Kc, frame, pos))
    assert int(got.max()) > 0 and int(got[:, -16:].abs().sum()) == 0  # dead rows score 0


@pytest.mark.requires_cuda
def test_exact_scores_kernel_on_odd_banks(cuda):
    """XS against its plain twin off the main path's shapes: T = 4 and 5,
    frames off the T grid, Fmax 37 (padded to 40) and 200 (the 8-slot
    variant), dead templates filling a whole 64-template tile, offsets
    past the Kc clamp, a frame whose rows take one band, and a patch too
    large for shared memory in one pass (Kc 16 at C*T*T 1024)."""
    rng = np.random.default_rng(4)
    cases = [(2, 16, 160, 160, 8, 6, 48, 70, 126), (3, 2, 92, 176, 4, 6, 40, 9, 20),
             (2, 3, 60, 230, 5, 4, 26, 130, 33), (1, 16, 240, 320, 8, 12, 96, 200, 200),
             (2, 16, 83, 101, 8, 4, 30, 65, 37), (1, 16, 16, 16, 8, 12, 96, 3, 8),
             (2, 16, 64, 80, 8, 16, 128, 20, 64)]
    for B, C, H, W, T, Kc, ext, N, F in cases:
        Rb = torch.from_numpy(rng.integers(0, 5, (B, C, H, W)).astype(np.uint8)).to(cuda)
        live = torch.from_numpy(rng.random((N, F)) < 0.9)
        if N >= 100:
            live[:64] = False  # a whole tile of dead templates
        feats = TM.LevelFeatures(
            torch.from_numpy(rng.integers(0, ext, (N, F, 2)).astype(np.int32)),
            torch.from_numpy(rng.integers(0, C, (N, F)).astype(np.int32)), live,
            live.sum(1).int(), torch.full((N, 2), ext, dtype=torch.int32)).to(cuda)
        table = TM.build_gemm_table(feats, C, T, Kc)
        P = (H // T) * (W // T)
        frame = torch.from_numpy(np.sort(rng.integers(0, B, 50))).to(cuda)
        pos = torch.from_numpy(rng.integers(0, P, 50)).to(cuda)
        for fr, po in ((None, None), (frame, pos)):
            got = CK.exact_scores(Rb, table, T, Kc, fr, po)
            assert torch.equal(got, CK.exact_scores_plain(Rb, table, T, Kc, fr, po)), (
                (B, C, H, W, T, Kc, N, F), fr is None)


# The pooled matcher's routes on the golden crops (15 x 20 level-1 cells a
# frame), pools as large as the frames so that only the named overflow
# happens: (BatchedMatcher keywords, launches of XS, the batch falls back)
EXACT_ROUTES = {
    "exact_tier": ({}, 1, False),
    "coarse_overflow": (dict(pool_coarse=1), 1, True),
    "select_overflow": (dict(sel_row_cap=1), 2, True),
}


def _exact_route_kw(B: int, route: str) -> dict:
    kw = dict(top_k=64, prune=True, prune_mode="pooled", fine_g=4, group_bound=16,
              pool_coarse=B * 300, pool_fine=B * 300, pool_group=B * 300, sel_row_cap=300)
    kw.update(EXACT_ROUTES[route][0])
    return kw


@pytest.mark.requires_cuda
@pytest.mark.parametrize("route", list(EXACT_ROUTES))
def test_pooled_matcher_scores_through_xs_alone(cuda, monkeypatch, route):
    """The pooled matcher on the card launches XS once for its exact tier
    and once for its exhaustive fallback, holds no dense one-hot operand,
    never runs torch._int_mm (its bounds go through BM, its exact scores
    through XS), and matches the CPU matcher (the int8 GEMM) on every
    slot."""
    td = Detector.read(BANK)
    cid = td.class_ids[0]
    B = 2
    _, launches, fallback = EXACT_ROUTES[route]
    kw = _exact_route_kw(B, route)
    rgbs, deps = S.golden_crops()
    m = BatchedMatcher(td, cid, 70.0, B, device=cuda, **kw)
    assert m.weights.exact.dense is None
    k_exact = 16 * 8 * 8 * m.Kc1 ** 2  # C * T * T * Kc * Kc
    seen = []
    int8_mm = TM.int8_mm
    monkeypatch.setattr(TM, "int8_mm", lambda a, w: (seen.append(w.nk.shape[1]),
                                                     int8_mm(a, w))[1])
    tracing.reset()
    got = m.match_batch(rgbs, deps)
    assert tracing.launches()["exact_scores"] == launches
    assert tracing.launches()["bound_margins"] > 0
    assert k_exact not in seen and not seen
    assert bool(m.last_pool.fallback) == fallback
    want = BatchedMatcher(td, cid, 70.0, B, device="cpu", **kw).match_batch(rgbs, deps)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.requires_cuda
def test_plain_pooled_matcher_launches_no_kernel(cuda):
    """`plain=True` on the card: the pooled matcher's bound tiers take BM's
    plain twin, its exact tier and its exhaustive fallback XS's, so no
    route of the batch launches a hand-written kernel (BM included, which
    the kernel path launches), and each equals the kernel path on every
    slot."""
    td = Detector.read(BANK)
    cid = td.class_ids[0]
    B = 2
    rgbs, deps = S.golden_crops()
    for route, (_, _, fallback) in EXACT_ROUTES.items():
        kw = _exact_route_kw(B, route)
        tracing.reset()
        want = BatchedMatcher(td, cid, 70.0, B, device=cuda, **kw).match_batch(rgbs, deps)
        assert tracing.launches()["bound_margins"] > 0, route
        m = BatchedMatcher(td, cid, 70.0, B, device=cuda, plain=True, **kw)
        tracing.reset()
        got = m.match_batch(rgbs, deps)
        assert tracing.launches()["bound_margins"] == 0, route
        assert not any(tracing.launches().values()), (route, tracing.launches())
        assert bool(m.last_pool.fallback) == fallback, route
        for a, b in zip(got, want):
            assert torch.equal(a, b), route


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", [*KC.BOUND_MARGIN_CASES, *KC.BOUND_MARGIN_SHAPES])
def test_bound_margins_kernel_equals_plain(cuda, case):
    """BM against its plain twin (torch._int_mm and the epilogue it
    replaced), bitwise, on the odd operand sets (n % 8 != 0, M <= 16, K %
    16 != 0, full-range int8, one template, dead pool slots) and at the
    batch cells' shapes: planted's and fullbin's group, cell and fine
    tiers, twoobj's every-position bound, ensenso's cell and fine tiers."""
    args = KC.bound_margin_case(case, cuda)
    tracing.reset()
    got = CK.bound_margins(*args)
    assert tracing.launches()["bound_margins"] == 1
    want = CK.bound_margins_plain(*args)
    assert got.dtype == torch.int32 and torch.equal(got, want)


# route -> BM launches a batch: the group, cell and fine tiers; the group
# and cell tiers alone when the coarse pool overflows; the merged
# two-object matcher's every-position bound and fine tier
BOUND_ROUTES = {"pooled": 3, "coarse_overflow": 2, "merged": 2}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("route", list(BOUND_ROUTES))
def test_pooled_matcher_launches_bound_margins(cuda, route):
    """The pooled matcher's bounds on the card are BM's launches, one a
    bound tier (3 a batch without overflow, 2 on a coarse overflow, 2 in
    the merged two-object matcher, which has no group tier), and every
    Matches slot equals the plain matcher's."""
    td = Detector.read(BANK)
    cid = td.class_ids[0]
    B = 2
    rgbs, deps = S.golden_crops()
    if route == "merged":
        bank = td.bank(cid)
        td.attach_bank(TemplateBank("second", bank.params, bank.templates))
        kw = dict(top_k=64, prune_mode="pooled", pool_coarse=300 * B, pool_fine=300 * B,
                  sel_row_cap=300)
        make = lambda plain: MultiClassBatchedMatcher(td, [cid, "second"], [70.0, 72.0], B,
                                                      device=cuda, plain=plain, **kw)
    else:
        kw = _exact_route_kw(B, "exact_tier" if route == "pooled" else route)
        make = lambda plain: BatchedMatcher(td, cid, 70.0, B, device=cuda, plain=plain, **kw)
    m = make(False)
    tracing.reset()
    got = m.match_batch(rgbs, deps)
    assert tracing.launches()["bound_margins"] == BOUND_ROUTES[route], tracing.launches()
    assert bool(m.last_pool.coarse_overflow) == (route == "coarse_overflow")
    want = make(True).match_batch(rgbs, deps)
    if route == "merged":
        got, want = [got[c] for c in (cid, "second")], [want[c] for c in (cid, "second")]
    else:
        got, want = [got], [want]
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert torch.equal(a, b)


def _tiled_matcher(cuda, B: int, **kw) -> BatchedMatcher:
    """The production pooled matcher at batch B over the bank tiled to
    10,624 templates (batch32-fullbin's configuration)."""
    td = Detector.read(BANK)
    cid = td.class_ids[0]
    bank = td.bank(cid)
    td.attach_bank(bank.tile(-(-10240 // bank.num_templates), 10624))
    return BatchedMatcher(td, cid, 91.0, B, device=cuda, **{**slice_settings(B), **kw})


def _select_case(cuda, name: str):
    """(raw (B, P, N) int32, total_features (N,), vpos (P, N) bool or a
    list of per-class ClassColumns (their columns' windows), top_k, Wc) of
    TK's test case `name`."""
    g = torch.Generator().manual_seed(sum(map(ord, name)))
    rint = lambda lo, hi, shape: torch.randint(lo, hi, shape, generator=g, dtype=torch.int32)
    if name == "fullbin_b32":
        m = _tiled_matcher(cuda, 32)
        rgbs, deps, _ = S.bin_picking_batch(32, seed=7, objects=6)
        _, R1 = TM.preprocess_frames_batched(torch.from_numpy(rgbs).to(cuda),
                                             torch.from_numpy(deps).to(cuda), use_depth=True)
        Hc, Wc = R1.shape[2] // 8, R1.shape[3] // 8
        raw = TM.coarse_scores_gemm_flat_batched(R1, m.weights.exact, 8, m.Kc1)
        return raw, m.feats1.count, m._vpos_flat(Hc, Wc), 128, Wc
    B, P, N, k, Wc = {"all_equal": (3, 300, 2000, 128, 20),
                      "ties_at_kth": (4, 1200, 700, 128, 40),
                      "fewer_valid_than_k": (2, 1200, 2652, 128, 40),
                      "vpos_none": (2, 1200, 2652, 128, 40),
                      "detector_b1_k512": (1, 1200, 2652, 512, 40),
                      "k256": (8, 1200, 2652, 256, 40),
                      "odd_p_n": (5, 37, 1001, 100, 1),
                      "odd_p_n4": (3, 33, 524, 512, 3),
                      "k_past_pn": (2, 3, 5, 128, 3),
                      "signed": (3, 600, 1000, 300, 30),
                      "two_class": (4, 1200, 5304, 128, 40),
                      "eight_class_odd": (3, 150, 1031, 128, 15)}[name]
    raw = rint(0, 505, (B, P, N))
    count = rint(1, 127, (N,))
    vpos = torch.rand((P, N), generator=g) < 0.85
    if name == "all_equal":
        raw.fill_(77)
        count.fill_(63)
        vpos.fill_(True)
    elif name == "ties_at_kth":  # 50 keys above a tie of ~100k at the k-th
        raw = rint(0, 4, (B, P, N))
        count.fill_(63)
        flat = raw.view(B, -1)
        for b in range(B):
            flat[b, torch.randperm(P * N, generator=g)[:50]] = 9
    elif name == "fewer_valid_than_k":
        vpos = torch.rand((P, N), generator=g) < 40 / (P * N)
    elif name == "vpos_none":
        vpos.fill_(False)
    elif name == "signed":  # negative sims, -0.0 and int32 extremes
        raw = rint(-6, 6, (B, P, N))
        raw[:, :, :7] = torch.tensor([0, -1, 2**31 - 1, -2**31, 2**24 + 1, -(2**24 + 1), 3],
                                     dtype=torch.int32)
    elif name == "eight_class_odd":  # windows off the kernel's vectors; one with few live
        vpos[:, 300:301] = False
    to = lambda t: t.to(cuda)
    if name == "two_class":
        return (to(raw), to(count), TM._class_columns(to(vpos), [(0, 2652), (2652, N)],
                                                      [92.0, 94.0]), k, Wc)
    if name == "eight_class_odd":
        ends = [0, 129, 300, 301, 433, 600, 777, 901, N]
        return (to(raw), to(count), TM._class_columns(to(vpos), list(zip(ends, ends[1:])),
                                                      [90.0] * 8), k, Wc)
    return to(raw), to(count), to(vpos), k, Wc


SELECT_CASES = ["fullbin_b32", "all_equal", "ties_at_kth", "fewer_valid_than_k", "vpos_none",
                "detector_b1_k512", "k256", "odd_p_n", "odd_p_n4", "k_past_pn", "signed",
                "two_class", "eight_class_odd"]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", SELECT_CASES)
def test_select_topk_kernel_equals_plain(cuda, case):
    """TK against its plain twin, bit for bit on the values (their bits:
    -0.0 is not 0.0) and on every CoarseMatches field: at batch32-fullbin's
    shape on XS's scores of seeded six-object scenes; every score equal;
    ties straddling the k-th key; fewer valid positions than k and none
    (the -1.0 fillers, lowest index first); the detector's B=1 at k=512;
    k=256; P and N off the kernel's steps and vectors; k past P * N;
    negative scores and int32 extremes; a two-class split of the columns and
    eight windows of odd widths and offsets, each read in place (and the
    select over the window equals the masked select over every column)."""
    raw, count, vposes, top_k, Wc = _select_case(cuda, case)
    B, P, N = raw.shape
    whole = not isinstance(vposes, list)
    for win in [TM.ClassColumns(0, N, vposes, 90.0)] if whole else vposes:
        lo, vpos = win.lo, win.vpos
        scale = TM._sim_scale(count[lo:win.hi])
        k = min(top_k, P * vpos.shape[1])
        tracing.reset()
        vals, idx = CK.select_topk(raw, scale, vpos, k, lo)
        assert tracing.launches()["select_topk"] == 1
        want_vals, want_idx = CK.select_topk_plain(raw, scale, vpos, k, lo)
        assert torch.equal(vals.view(torch.int32), want_vals.view(torch.int32)), case
        assert torch.equal(idx, want_idx), case
        got = TM.select_candidates_flat(raw, count, vpos, 90.0, top_k, Wc, lo=lo)
        want = TM.select_candidates_flat(raw, count, vpos, 90.0, top_k, Wc, plain=True, lo=lo)
        if not whole:  # the window's select is the masked select over every column
            col = torch.arange(N, device=cuda)
            masked = torch.zeros((P, N), dtype=torch.bool, device=cuda)
            masked[:, lo:win.hi] = vpos
            assert torch.equal(masked, masked & ((col >= lo) & (col < win.hi)))
            full = TM.select_candidates_flat(raw, count, masked, 90.0, top_k, Wc)
            for name, a, b in zip(got._fields, got, full):
                if a.dtype == torch.float32:
                    a, b = a.view(torch.int32), b.view(torch.int32)
                assert torch.equal(a, b), (case, "masked", name)
        for name, a, b in zip(got._fields, got, want):
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), (case, name)


@pytest.mark.requires_cuda
def test_select_topk_kernel_refuses_what_it_does_not_take(cuda):
    raw = torch.zeros((2, 30, 40), dtype=torch.int32, device=cuda)
    scale = torch.ones(40, device=cuda)
    vpos = torch.ones((30, 40), dtype=torch.bool, device=cuda)
    for k in (0, 513):
        with pytest.raises(ValueError, match="TK takes"):
            CK.select_topk(raw, scale, vpos, k)
    with pytest.raises(ValueError, match="int32"):
        CK.select_topk(raw.float(), scale, vpos, 8)
    with pytest.raises(ValueError, match="shape"):
        CK.select_topk(raw, scale[:-1], vpos, 8)
    with pytest.raises(ValueError, match="does not lie"):  # a window past raw's columns
        CK.select_topk(raw, scale[:-1], vpos[:, :-1], 8, lo=2)


@pytest.mark.requires_cuda
def test_fullbin_fallback_launches_select_topk_once_a_class(cuda):
    """batch32-fullbin's matcher on six-object frames, its coarse pool
    forced small, overflows it on every batch as fullbin's scenes do, so
    the batch falls back: XS and TK launch once each, with one threshold
    copy for the select; the two-object matcher's fallback launches TK
    once a class; the plain matchers never launch it; every Matches field
    equals the plain matcher's."""
    B = 32
    rgbs, deps, _ = S.bin_picking_batch(B, seed=11, objects=6)
    m = _tiled_matcher(cuda, B, pool_coarse=8)
    tracing.reset()
    got = m.match_batch(rgbs, deps)
    assert bool(m.last_pool.coarse_overflow)
    launches = tracing.launches()
    assert launches["exact_scores"] == 1 and launches["select_topk"] == 1, launches
    assert tracing.counters["sync"] == 8, tracing.counters
    plain = _tiled_matcher(cuda, B, pool_coarse=8, plain=True)
    tracing.reset()
    want = plain.match_batch(rgbs, deps)
    assert not any(tracing.launches().values()), tracing.launches()
    for a, b in zip(got, want):
        assert torch.equal(a, b)

    td = Detector.read(BANK)
    cid = td.class_ids[0]
    bank = td.bank(cid)
    td.attach_bank(TemplateBank("second", bank.params, bank.templates))
    g_rgbs, g_deps = S.golden_crops()
    kw = dict(top_k=64, prune_mode="pooled", pool_coarse=1, pool_fine=72)
    out = {}
    for plain in (False, True):
        mc = MultiClassBatchedMatcher(td, [cid, "second"], [70.0, 72.0], 2, device=cuda,
                                      plain=plain, **kw)
        tracing.reset()
        out[plain] = mc.match_batch(g_rgbs, g_deps)
        assert bool(mc.last_pool.fallback)
        assert tracing.launches()["select_topk"] == (0 if plain else 2)
    for c in (cid, "second"):
        for a, b in zip(out[False][c], out[True][c]):
            assert torch.equal(a, b), c


# keyword arguments of BatchedMatcher(prune=True) -> (coarse, fine) overflow;
# the caps of 1 put B * m_cap rows under torch._int_mm's m > 16
PRUNE_CASES = {
    "positions": ({}, False, False),
    "positions_fine_overflow": (dict(fine_pos_cap=1), False, True),
    "positions_coarse_overflow": (dict(prune_pos_cap=1), True, False),
    "positions_no_fine_stage": (dict(fine_g=None), False, None),
    "two_axis": (dict(prune_mode="two_axis"), False, None),
    "two_axis_overflow": (dict(prune_mode="two_axis", prune_cap=3, prune_pos_cap=2),
                          True, None),
}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", list(PRUNE_CASES))
def test_prune_modes_on_the_card(cuda, case):
    """The positions and two_axis modes on the card: the kernel path equals
    the plain path there, and both equal the plain path on the CPU (every
    Matches slot, PrunePlan and FinePlan), so cuBLASLt's int8 GEMMs and the
    card's top-k give the host's plans; K1-K3 launch."""
    kw, coarse_of, fine_of = PRUNE_CASES[case]
    td = Detector.read(BANK)
    cid = td.class_ids[0]
    bank = td.bank(cid)
    sub = Detector(bank.params)
    sub.attach_bank(TemplateBank(cid, bank.params,
                                 [bank.templates[i] for i in S.CROP_BANK_SUBSET]))
    rgbs, deps = S.golden_crops()
    B = rgbs.shape[0]
    make = lambda **k: BatchedMatcher(sub, cid, 70.0, B, top_k=64, prune=True, **kw, **k)
    mk, mp, mc = make(device=cuda), make(device=cuda, plain=True), make(device="cpu")
    tracing.reset()
    got = mk.match_batch(rgbs, deps)
    counts = tracing.launches()
    assert (counts["quantize_cg"], counts["spread_response"], counts["walk_scores"]) == (2, 4, 1)
    for m in (mp, mc):
        want = m.match_batch(rgbs, deps)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b.cpu())
        for a, b in zip(mk.last_prune, m.last_prune):
            assert torch.equal(a.cpu(), b.cpu())
        assert (mk.last_fine is None) == (m.last_fine is None) == (fine_of is None)
        if fine_of is not None:
            for a, b in zip(mk.last_fine, m.last_fine):
                assert torch.equal(a.cpu(), b.cpu())
    assert bool(mk.last_prune.overflow) == coarse_of
    assert fine_of is None or bool(mk.last_fine.overflow) == fine_of
    assert int(got.valid.sum()) > 0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kw", [{}, dict(prune_pos_cap=2, fine_pos_cap=2)],
                         ids=["defaults", "coarse_overflow"])
def test_multiclass_positions_on_the_card(cuda, kw):
    """MultiClassBatchedMatcher's default mode: kernel path == plain path
    on the card == the CPU, per class, and the PrunePlan."""
    td = Detector.read(BANK)
    cid = td.class_ids[0]
    bank = td.bank(cid)
    det = Detector(bank.params)
    for c, ids in (("a", S.CROP_MATCHING[::2] + list(range(1, 2652, 211))),
                   ("b", S.CROP_MATCHING[1::2] + list(range(60, 2652, 173)))):
        det.attach_bank(TemplateBank(c, bank.params, [bank.templates[i] for i in ids]))
    rgbs, deps = S.golden_crops()
    B = rgbs.shape[0]
    make = lambda **k: MultiClassBatchedMatcher(det, ["a", "b"], [70.0, 72.0], B,
                                                top_k=64, **kw, **k)
    mk, mp, mc = make(device=cuda), make(device=cuda, plain=True), make(device="cpu")
    got = mk.match_batch(rgbs, deps)
    for m in (mp, mc):
        want = m.match_batch(rgbs, deps)
        for c in ("a", "b"):
            for a, b in zip(got[c], want[c]):
                assert torch.equal(a.cpu(), b.cpu())
        for a, b in zip(mk.last_prune, m.last_prune):
            assert torch.equal(a.cpu(), b.cpu())
    assert bool(mk.last_prune.overflow) == bool(kw)
    assert int(got["a"].valid.sum()) > 0 and int(got["b"].valid.sum()) > 0


@pytest.mark.requires_cuda
def test_rgb_only_bank_on_the_card(cuda):
    """The one-modality bank (C = 8): K1 x2 and K2 x2 only, pooled and
    positions equal to their plain paths."""
    td = Detector.read("data/boxNew_full_templates.yml.gz")
    cid = td.class_ids[0]
    bank = td.bank(cid)
    sub = Detector(bank.params)
    sub.attach_bank(TemplateBank(cid, bank.params,
                                 [bank.templates[i] for i in sorted(S.CROP_BANK_SUBSET)]))
    rgbs, _ = S.golden_crops()
    for kw in (dict(prune_mode="pooled"), dict()):
        make = lambda **k: BatchedMatcher(sub, cid, 60.0, 2, top_k=64, prune=True,
                                          device=cuda, **kw, **k)
        tracing.reset()
        got = make().match_batch(rgbs)
        counts = tracing.launches()
        assert (counts["quantize_cg"], counts["spread_response"]) == (2, 2)
        for a, b in zip(got, make(plain=True).match_batch(rgbs)):
            assert torch.equal(a, b)
        assert int(got.valid.sum()) > 0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape,kw", [((32, 480, 752), {}), ((32, 480, 752, 3), {}),
                                      ((3, 37, 61), dict(bias_x=0, crop_w=61, crop_h=37)),
                                      ((3, 37, 61, 3), dict(bias_x=5, crop_w=50, crop_h=30))])
def test_condition_frames_on_the_card_equal_the_cpu(cuda, shape, kw):
    """The service's conditioning over a batch (ops/features.py::
    condition_frames) on the card, bit for bit the CPU's, which the CPU
    tests hold to condition_frame: the Ensenso's B=32 mono and 3-channel
    752x480 frames, and odd sizes whose crop reaches the wrapped edges."""
    g = torch.Generator().manual_seed(shape[1] * 10 + len(shape))
    frames = torch.randint(0, 256, shape, generator=g, dtype=torch.uint8)
    frames[:, 0] = 255
    got = TF.condition_frames(frames.to(cuda), **kw)
    assert got.is_cuda and got.is_contiguous()
    assert torch.equal(got.cpu(), TF.condition_frames(frames, **kw))


@pytest.mark.requires_cuda
def test_conditioned_batch_on_the_card(cuda):
    """BatchedMatcher with the service's conditioning over the colour-only
    bank at its one-modality pools: raw mono 752-wide frames, copied once
    and conditioned on the card, give the Matches of the same matcher on
    the frames conditioned on the host, and of the plain path; the
    conditioned batch syncs as often as the unconditioned one."""
    from linemod_pose_estimation_tpu_torch.api.service import (Frame, FrameConditioning,
                                                               condition_frame)

    rgbs = np.load(CASCADE_GOLDEN)["rgb"]  # the cuboid at three bank poses, a background
    c = rgbs.astype(np.int32)
    mono = ((4899 * c[..., 0] + 9617 * c[..., 1] + 1868 * c[..., 2] + 8192) >> 14
            ).astype(np.uint8)
    wide = np.random.default_rng(5).integers(0, 256, (4, 480, 752), dtype=np.uint8)
    wide[:, :, 56:696] = mono
    host = np.stack([condition_frame(Frame(f, None)).rgb for f in wide])
    td = Detector.read(RGB_BANK)
    cid = td.class_ids[0]
    make = lambda **k: BatchedMatcher(td, cid, 85.0, 4, device=cuda,
                                      **slice_settings(4, modalities=1), **k)
    runs = []
    for m, frames in ((make(conditioning=FrameConditioning()), wide), (make(), host),
                      (make(conditioning=FrameConditioning(), plain=True), wide)):
        m.match_batch(frames)  # warm-up
        tracing.reset()
        runs.append((m.match_batch(frames), dict(tracing.counters)))
    (got, cond), (want, host_counts), (plain, _) = runs
    for a, b, p in zip(got, want, plain):
        assert torch.equal(a, b) and torch.equal(a, p)
    assert int(got.valid.sum()) > 0
    assert cond.pop("condition.frames") == 4
    assert cond == host_counts and cond["sync"] > 0


@pytest.mark.requires_cuda
def test_k5_chain_and_two_object_kernels_equal_plain(cuda):
    """The exhaustive mode's candidates through the K5 refiner, and the
    two-object matcher (the bank under two class ids), kernels against
    plain; K5 launched."""
    td = Detector.read(BANK)
    cid = td.class_ids[0]
    bank = td.bank(cid)
    rgbs, deps = S.golden_crops()
    B = rgbs.shape[0]
    m = BatchedMatcher(td, cid, 70.0, B, top_k=64, device=cuda)
    R0, cands, _ = m.candidates(rgbs, deps)
    tracing.reset()
    got = TM.refine_candidates_pallas_batched(R0, m.feats0, cands, m.T1, 70.0, m.E0,
                                              fine_T=m.T0)
    assert tracing.launches()["refine_scores"] == 1
    want = TM.refine_candidates_pallas_batched(R0, m.feats0, cands, m.T1, 70.0, m.E0,
                                               fine_T=m.T0, plain=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    td.attach_bank(TemplateBank("second", bank.params, bank.templates))
    kw = dict(top_k=64, prune_mode="pooled", pool_coarse=56 * B, pool_fine=36 * B,
              device=cuda)
    got = MultiClassBatchedMatcher(td, [cid, "second"], [70.0, 72.0], B, **kw)
    want = MultiClassBatchedMatcher(td, [cid, "second"], [70.0, 72.0], B, plain=True, **kw)
    g, w = got.match_batch(rgbs, deps), want.match_batch(rgbs, deps)
    for c in (cid, "second"):
        for a, b in zip(g[c], w[c]):
            assert torch.equal(a, b)
    for a, b in zip(got.last_pool, want.last_pool):
        assert torch.equal(a, b)


@pytest.mark.requires_cuda
def test_raster_kernel_equals_plain(cuda):
    """K4 at the cascade's shapes (the cuboid, four bank poses, the
    256x256 viewport) and an off-screen pose: depth, mask, shade."""
    meta, glob = TemplateBank.read_params_yaml(PARAMS)
    tris = torch.from_numpy(_pad_triangles(S.cuboid_mesh().triangles, 64)).to(cuda)
    K = torch.tensor([[glob.focal_length_x, 0, 128.0], [0, glob.focal_length_y, 128.0],
                      [0, 0, 1]], dtype=torch.float32, device=cuda).expand(5, 3, 3)
    R = torch.tensor(np.concatenate([meta.R[[0, 700, 1400, 2000]], np.eye(3)[None]]),
                     dtype=torch.float32, device=cuda)
    T = torch.tensor(np.concatenate([meta.T[[0, 700, 1400, 2000]], [[10.0, 0.0, 0.5]]]),
                     dtype=torch.float32, device=cuda)
    coefs = RA.triangle_coefficients(tris, R, T, K)
    zk, sk = RA.raster_zbuffer(coefs, 256, 256)
    zp, sp = RA.raster_zbuffer_plain(coefs, 256, 256)
    assert torch.equal(zk, zp) and torch.equal(sk, sp)
    assert bool(torch.isfinite(zk[:4]).any()) and not bool(torch.isfinite(zk[4]).any())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", ["dup_rows_tie", "dense_tile", "viewport_250x170",
                                  "viewport_1x1", "frame_640x480"])
def test_raster_kernel_on_odd_cases(cuda, name):
    """K4 against its plain version on chip_smoke's odd cases
    (utils/kernel_cases.py): exact depth ties that only the first row may
    win, a tile that more than 256 triangles reach, viewports off the
    16-pixel tile and of one pixel, and the full 640x480 frame."""
    if name == "frame_640x480":
        meta, glob = TemplateBank.read_params_yaml(PARAMS)
        tris = torch.from_numpy(_pad_triangles(S.cuboid_mesh().triangles, 64)).to(cuda)
        K = torch.tensor([[glob.focal_length_x, 0, 320.0], [0, glob.focal_length_y, 240.0],
                          [0, 0, 1]], dtype=torch.float32, device=cuda)[None]
        coefs = RA.triangle_coefficients(
            tris, torch.tensor(meta.R[[0]], dtype=torch.float32, device=cuda),
            torch.tensor(meta.T[[0]], dtype=torch.float32, device=cuda), K)
        w, h = 640, 480
    else:
        coefs, w, h = KC.raster_cases(cuda, PARAMS)[name]
    zk, sk = RA.raster_zbuffer(coefs, w, h)
    zp, sp = RA.raster_zbuffer_plain(coefs, w, h)
    assert torch.equal(zk, zp) and torch.equal(sk, sp)
    assert bool(torch.isfinite(zk).any())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("use_depth", [False, True])
def test_preprocess_frame_kernels_equal_plain(cuda, use_depth):
    """The single-frame preprocess at 480x640: its B=1 K1 and K2 launches
    against the plain path."""
    with np.load(CASCADE_GOLDEN) as z:
        rgb = torch.from_numpy(z["rgb"][0]).to(cuda)
        dep = torch.from_numpy(z["depth_mm"][0]).to(cuda)
    got = TM.preprocess_frame(rgb, dep, use_depth=use_depth)
    want = TM.preprocess_frame(rgb, dep, use_depth=use_depth, plain=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _depth_normal_input(name, dev):
    """(depth_mm, distance_threshold, difference_threshold) of one DN case:
    the B=32 scene batch, one trainer chunk's renders (fractional depths,
    zbuf * 1000), or a set of utils/kernel_cases.py."""
    if name == "scenes_b32":
        return torch.from_numpy(S.bin_picking_batch(32, seed=5)[1]).to(dev), 2000.0, 50.0
    if name == "trainer_renders":
        from linemod_pose_estimation_tpu_torch.models import trainer as TTR
        from linemod_pose_estimation_tpu_torch.models.renderer import Renderer
        from linemod_pose_estimation_tpu_torch.utils.viewsphere import generate_views

        cfg = TTR.TrainerConfig()
        views = generate_views(cfg.view_sphere)[:cfg.render_batch]
        r = Renderer(S.cuboid_mesh(), cfg.width, cfg.height, cfg.focal_length_x,
                     cfg.focal_length_y, device=dev)
        out = r.render_batch([v.R for v in views], [v.T for v in views])
        depth = cfg.detector.depth
        return out.depth_mm, depth.distance_threshold, depth.difference_threshold
    return KC.depth_normal_cases(dev)[name]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", ["scenes_b32", "trainer_renders", *KC.DEPTH_NORMAL_CASES])
def test_depth_normal_kernel_equals_plain(cuda, name):
    """DN against the plain DepthNormal, bit for bit: the batch's scenes,
    the trainer's renders, and the edge cases (thresholds crossed by
    fractional millimetres, 49-51 mm steps, holes, depths near 65535,
    shapes off the tile and below the band, int32 input)."""
    depth, dist, diff = _depth_normal_input(name, cuda)
    tracing.reset()
    got = CP.quantize_depth_normal(depth, dist, diff)
    assert tracing.launches()["depth_normal"] == 1
    want = CP.quantize_depth_normal_plain(depth, dist, diff)
    assert got.dtype == torch.uint8 and torch.equal(got, want)
    if name in ("scenes_b32", "trainer_renders"):
        assert (got > 0).float().mean() > 0.02


@pytest.mark.requires_cuda
def test_depth_normal_launches_once_per_preprocess_and_quantize_levels(cuda):
    """One DN launch per preprocess_frames_batched call with depth (none
    without, none on the plain path) and per templates.quantize_levels."""
    from linemod_pose_estimation_tpu_torch.models import templates as TT

    with np.load(CASCADE_GOLDEN) as z:
        rgbs = torch.from_numpy(z["rgb"]).to(cuda)
        deps = torch.from_numpy(z["depth_mm"]).to(cuda)
    for kw, n in ((dict(use_depth=True), 1), (dict(use_depth=False), 0),
                  (dict(use_depth=True, plain=True), 0)):
        tracing.reset()
        TM.preprocess_frames_batched(rgbs, deps, **kw)
        assert tracing.launches()["depth_normal"] == n, kw
    tracing.reset()
    TT.quantize_levels(rgbs, deps, TT.DetectorParams(use_depth_normal=True))
    assert tracing.launches()["depth_normal"] == 1


@pytest.mark.requires_cuda
def test_detect_on_the_card_launches_every_kernel(cuda):
    """DetectionPipeline.detect at full width on golden frame 0: Matches
    equal to the JAX reference's, a detection, and K1-K4 launched."""
    with np.load(CASCADE_GOLDEN) as z:
        g = {k: z[k] for k in z.files}
    pipe = DetectionPipeline.from_files(BANK, PARAMS, S.cuboid_mesh(), device=cuda)
    dep = torch.from_numpy(g["depth_mm"][0]).to(cuda)
    cloud = TP.depth_to_cloud(TP.true_div(dep, 1000.0), pipe.K_render)
    tracing.reset()
    dets, st = pipe.detect(g["rgb"][0], cloud, threshold=float(g["threshold"]),
                           depth_mm=dep, return_stages=True)
    for name, a in st.matches._asdict().items():
        np.testing.assert_array_equal(a.cpu().numpy(), g["m_" + name][0], err_msg=name)
    assert len(dets) >= 1
    for k in ("quantize_cg", "spread_response", "walk_scores", "raster_zbuffer"):
        assert tracing.launches()[k] > 0, k


# ---------------------------------------------------------------------------
# The cascade's non-default options: the same PyTorch code on the card and on
# the CPU (no kernel of their own; the detect launches K1-K4).  Tolerances:
# integers and flags equal, floats within the figure each test states (the
# card's matmuls, solves and eigh sum in another order than the CPU's).
# ---------------------------------------------------------------------------


def _sweep_clouds(stem, device):
    with np.load(f"data/{stem}.npz") as z:
        return [torch.from_numpy(z[k]).to(device)
                for k in ("model", "mvalid", "scene", "snorm", "svalid")]


def _perturbed(model, mvalid, deg=3.0, shift=0.003):
    """The model rotated about z through its centroid and shifted."""
    th = np.deg2rad(deg)
    R = torch.tensor([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]],
                     dtype=torch.float32, device=model.device)
    c = model[mvalid].mean(0)
    return torch.where(mvalid[:, None], (model - c) @ R.T + c + shift, model)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("variant", ["plane", "lm", "schedule"])
def test_icp_variants_on_the_card_equal_cpu(cuda, variant):
    """Two lanes (the two real clouds, perturbed) through each new ICP on
    the card and on the CPU: transforms within 1e-4, iterations and flags
    equal, inliers within 2.  LM's accept test flips on an ulp of the cost
    and its epsilon of 1e-8 sits inside nearest-neighbour jitter, so its
    passes may end up to 3 iterations apart."""
    from linemod_pose_estimation_tpu_torch.ops import icp as TI

    def run(device):
        lanes = [_sweep_clouds(s, device) for s in ("sweep_view00_clouds",
                                                    "sweep_view45_clouds")]
        m, mv, s, n, sv = (torch.stack(a) for a in zip(*lanes))
        m = torch.stack([_perturbed(a, b) for a, b in zip(m, mv)])
        if variant == "plane":
            return TI.icp_two_stage_plane(m, mv, s, n, sv, coarse_iterations=40)
        if variant == "lm":
            return TI.icp_lm(m, mv, s, sv, max_iterations=50)
        return TI.icp_schedule(m, mv, s, sv, ((30, 0.05, 0.02, 1e-5), (10, 0.02, 0.01, 1e-6)))

    got, want = run(cuda), run("cpu")
    assert got.transform.is_cuda
    np.testing.assert_allclose(got.transform.cpu().numpy(), want.transform.numpy(), atol=1e-4)
    slack = 3 if variant == "lm" else 0
    assert int((got.iterations.cpu() - want.iterations).abs().max()) <= slack
    assert torch.equal(got.converged.cpu(), want.converged)
    assert int((got.num_inliers.cpu() - want.num_inliers).abs().max()) <= 2


@pytest.mark.requires_cuda
def test_depth_normals_on_the_card_equal_cpu(cuda):
    from linemod_pose_estimation_tpu_torch.ops import verification as TV

    with np.load(CASCADE_GOLDEN) as z:
        dep = torch.from_numpy(z["depth_mm"][0])
    K = torch.tensor([[572.4, 0, 320.0], [0, 573.6, 240.0], [0, 0, 1]])
    got, want = TV.depth_normals(dep.to(cuda), K.to(cuda)).cpu(), TV.depth_normals(dep, K)
    assert torch.equal(got.abs().sum(-1) > 0, want.abs().sum(-1) > 0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-6)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("stem,true_deg", [("sweep_view45_clouds", 3.02),
                                           ("sweep_view00_clouds", 1.35)])
def test_inplane_sweep_on_the_card(cuda, stem, true_deg):
    """The sweep repair on the real tail views: applied, within 0.5
    degrees of the truth, T_fix within 2e-5 of the CPU's."""
    from linemod_pose_estimation_tpu_torch.models import cascade as TC

    on = lambda dev: TC.inplane_sweep_fix(*_sweep_clouds(stem, dev),
                                          torch.tensor(True, device=dev), 6.0, 0.7)
    (T, applied), (Tc, applied_c) = on(cuda), on("cpu")
    assert bool(applied) and bool(applied_c)
    np.testing.assert_allclose(T.cpu().numpy(), Tc.numpy(), atol=2e-5)
    R = T.cpu().numpy()[:3, :3]
    ang = np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))
    assert abs(ang - true_deg) < 0.5


@pytest.mark.requires_cuda
def test_local_descriptor_on_the_card_equals_cpu(cuda):
    """The local-descriptor pose of a rigidly moved real cloud: keypoints
    and the flag equal to the CPU's, votes and correspondences within 2 (a
    descriptor distance at the 0.25 gate, or a support point on a bin edge,
    can fall either side: 67 against 66 correspondences measured), the pose
    within 1e-4 and on the planted motion."""
    from linemod_pose_estimation_tpu_torch.ops import local_descriptor as TL

    def run(device):
        model, mv, *_ = _sweep_clouds("sweep_view00_clouds", device)
        scene = _perturbed(model, mv, deg=20.0, shift=0.01)
        ki, kv = TL.select_keypoints(model, mv, 0.008, 96)
        return ki, kv, TL.get_pose_by_local_descriptor(
            model, mv, scene, mv, keypoint_leaf=0.008, k_cap=96), model, mv, scene

    (ki, kv, got, model, mv, scene), (ki_c, kv_c, want, *_) = run(cuda), run("cpu")
    assert torch.equal(ki.cpu(), ki_c) and torch.equal(kv.cpu(), kv_c)
    assert abs(int(got.votes) - int(want.votes)) <= 2
    assert abs(int(got.n_correspondences) - int(want.n_correspondences)) <= 2
    assert bool(got.valid) and bool(want.valid)
    np.testing.assert_allclose(got.pose.cpu().numpy(), want.pose.numpy(), atol=1e-4)
    moved = model[mv] @ got.pose[:3, :3].T + got.pose[:3, 3]
    assert float((moved - scene[mv]).abs().max()) < 0.005


@pytest.mark.requires_cuda
@pytest.mark.parametrize("config", ["accuracy", "accuracy_refine", "nonlinear", "roi_center",
                                    "distance_offset", "local_descriptor"])
def test_detect_options_on_the_card_equal_the_golden(cuda, config):
    """DetectionPipeline.detect at full width in each non-default
    configuration on golden frame 0: the ClusterSet, valid flags and rects
    equal to the JAX reference's, poses within 0.01 degrees / 0.01 mm (LM
    ICP within 0.05 / 0.05: its passes end elsewhere on the plateau of its
    1e-8 epsilon; 0.027 / 0.035 measured), K1-K4 launched."""
    from linemod_pose_estimation_tpu_torch.models import cascade as TC
    from linemod_pose_estimation_tpu_torch.utils.geometry import rotation_geodesic_deg

    with np.load(CASCADE_GOLDEN) as z:
        g = {k: z[k] for k in ("rgb", "depth_mm", "threshold")}
    with np.load("tests/data/torch_cascade_options_golden.npz") as z:
        og = {k[len(config) + 1:]: z[k] for k in z.files if k.startswith(config + "_")}
    options = TC.GOLDEN_OPTION_SETS[config][0]
    pipe = DetectionPipeline.from_files(BANK, PARAMS, S.cuboid_mesh(),
                                        TC.CascadeParams(**options), device=cuda)
    dep = torch.from_numpy(g["depth_mm"][0]).to(cuda)
    cloud = TP.depth_to_cloud(TP.true_div(dep, 1000.0), pipe.K_render)
    tracing.reset()
    dets, st = pipe.detect(g["rgb"][0], cloud, threshold=float(g["threshold"]),
                           depth_mm=dep, return_stages=True)
    for k in ("quantize_cg", "spread_response", "walk_scores", "raster_zbuffer"):
        assert tracing.launches()[k] > 0, k
    for name in ("count", "bbox", "valid", "member_idx", "member_valid"):
        np.testing.assert_array_equal(getattr(st.clusters, name).cpu().numpy(),
                                      og["c_" + name][0], err_msg=name)
    np.testing.assert_array_equal(st.poses.valid.cpu().numpy(), og["p_valid"][0])
    np.testing.assert_array_equal(st.poses.rect.cpu().numpy(), og["p_rect"][0])
    assert len(dets) >= 1
    for lane in np.nonzero(og["p_valid"][0])[0]:
        got, want = st.poses.pose[lane].cpu().double(), torch.tensor(og["p_pose"][0][lane]).double()
        tol = 0.05 if config == "nonlinear" else 0.01
        assert float(rotation_geodesic_deg(got[:3, :3], want[:3, :3])) <= tol
        assert 1000.0 * float((got[:3, 3] - want[:3, 3]).norm()) <= tol


def _serving_fixture(cuda):
    """The serving golden, the cascade frames' replay clouds and the
    RGB-only pipeline on the card."""
    with np.load(SERVING_GOLDEN) as z:
        g = {k: z[k] for k in z.files}
    with np.load(CASCADE_GOLDEN) as z:
        rgbs, depths = z["rgb"], z["depth_mm"]
    meta, glob = TemplateBank.read_params_yaml(RGB_PARAMS)
    clouds = S.replay_clouds(depths, glob.focal_length_x, glob.focal_length_y)
    pipe = DetectionPipeline(Detector.read(RGB_BANK, device=cuda), meta, glob, S.cuboid_mesh())
    return g, rgbs, clouds, pipe


@pytest.mark.requires_cuda
def test_template_refinement_raster_on_the_card_equals_plain(cuda, monkeypatch):
    """K4 on the operands template_refinement gives it (one pose in the
    256 x 256 viewport), bitwise against plain; the refined pose within
    chip_smoke's 0.01 degrees / 0.01 mm of the reference's."""
    from linemod_pose_estimation_tpu_torch.models.serving import template_refinement

    g, _, clouds, pipe = _serving_fixture(cuda)
    seen, kernel = [], RA.raster_zbuffer
    monkeypatch.setattr(RA, "raster_zbuffer", lambda *a: seen.append(a) or kernel(*a))
    tracing.reset()
    T, _ = template_refinement(torch.from_numpy(g["det_pose"][0][0]).to(cuda),
                               torch.from_numpy(clouds[0]).to(cuda),
                               tuple(int(v) for v in g["det_rect"][0][0]), pipe.triangles,
                               pipe.K_render, pipe.render_wh)
    assert tracing.launches()["raster_zbuffer"] == 1 and len(seen) == 1
    coefs, w, h = seen[0]
    assert coefs.shape[0] == 1 and (w, h) == (256, 256)
    (zk, sk), (zp, sp) = kernel(coefs, w, h), RA.raster_zbuffer_plain(coefs, w, h)
    assert torch.equal(zk, zp) and torch.equal(sk, sp)
    want = g["refined_pose"][0][0].astype(np.float64)
    got = T.cpu().numpy().astype(np.float64)
    assert 1000 * np.linalg.norm(got[:3, 3] - want[:3, 3]) <= 0.01
    cos = np.clip((np.trace(got[:3, :3].T @ want[:3, :3]) - 1) / 2, -1, 1)
    assert np.degrees(np.arccos(cos)) <= 0.01


@pytest.mark.requires_cuda
def test_pipelined_runner_on_the_card_equals_blocking(cuda):
    """The pooled matcher on the cascade frames through PipelinedRunner
    (depth 2, CUDA events): the blocking calls' Matches, in order."""
    from linemod_pose_estimation_tpu_torch.models.serving import PipelinedRunner, slice_settings

    with np.load(CASCADE_GOLDEN) as z:
        rgbs = torch.from_numpy(z["rgb"]).to(cuda)
        deps = torch.from_numpy(z["depth_mm"]).to(cuda)
    det = Detector.read(BANK, device=cuda)
    m = BatchedMatcher(det, det.class_ids[0], 91.0, 4, device=cuda, **slice_settings(4))
    batches = [(rgbs.roll(k, 0), deps.roll(k, 0)) for k in range(5)]
    blocking = [m.match_batch(*b) for b in batches]
    run = PipelinedRunner(m.match_batch, depth=2, device=cuda)
    piped = [out for out in (run.submit(*b) for b in batches) if out is not None]
    assert len(run) == 2
    piped += run.drain()
    assert len(piped) == len(blocking)
    for a, b in zip(piped, blocking):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert int(blocking[0].valid.sum()) > 0


@pytest.mark.requires_cuda
def test_pose_service_on_the_card_against_the_golden(cuda):
    """PoseService on the card over the cascade frames: the reference's
    base-frame transforms within 0.01 degrees / 0.01 mm, the identity on
    the background frame and on an unknown id."""
    from linemod_pose_estimation_tpu_torch.api import transforms as TR
    from linemod_pose_estimation_tpu_torch.api.service import Frame, ObjectConfig, PoseService

    g, rgbs, clouds, pipe = _serving_fixture(cuda)
    cur = {"f": 0}
    svc = PoseService(lambda: Frame(rgbs[cur["f"]], clouds[cur["f"]]),
                      base_tool0_source=lambda: g["base_tool0"])
    svc.register_object(0, ObjectConfig(pipeline=pipe, threshold=float(g["threshold"])))
    identity = TR.Transform.identity()
    for f in range(len(rgbs)):
        cur["f"] = f
        t = svc.linemod_object_pose(0)
        if g["det_n"][f] == 0:
            assert t == identity
            continue
        x, y, z, w = g["svc_rotation"][f]
        want = TR.make_affine(*g["svc_translation"][f], w, x, y, z)
        x, y, z, w = t.rotation
        got = TR.make_affine(*t.translation, w, x, y, z)
        assert 1000 * np.linalg.norm(got[:3, 3] - want[:3, 3]) <= 0.01
        cos = np.clip((np.trace(got[:3, :3].T @ want[:3, :3]) - 1) / 2, -1, 1)
        assert np.degrees(np.arccos(cos)) <= 0.01
    assert svc.linemod_object_pose(int(g["unknown_id"])) == identity


# -- the trainer: K1's magnitude variant, the trainer on the card ----------


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape", [(480, 640), *ODD_SHAPES], ids=lambda s: f"{s[0]}x{s[1]}")
def test_quantize_cg_mag2_kernel_equals_plain(cuda, shape):
    """K1's trainer variant: the bitmask and the squared magnitudes equal
    the plain quantizer's bit for bit (u8, as f32, and its f32 pyrDown
    where the frame is wide enough for pyrDown's reflected border), and
    its bitmask equals the matcher's launch."""
    H, W = shape
    g = torch.Generator(device=cuda).manual_seed(H * 7 + W)
    rgb = torch.randint(0, 256, (3, H, W, 3), device=cuda, generator=g, dtype=torch.uint8)
    yy = torch.arange(H, device=cuda)[:, None].float()
    xx = torch.arange(W, device=cuda)[None, :].float()
    rgb[1, ..., 1] = ((torch.sin(yy / 5.0) + torch.cos(xx / 3.0)) * 60 + 128).to(torch.uint8)
    rgb[2] = 90  # flat: every magnitude 0
    xs = [rgb, rgb.float()]
    if min(H, W) >= 3:
        xs.append(torch.stack([TF.pyr_down(rgb[..., c].float()) for c in range(3)],
                              -1).contiguous())
    for x in xs:
        q, m = CP.quantize_color_gradient_mag2(x, 10.0)
        qp, mp = TF.quantize_color_gradient(x, 10.0)
        assert m.dtype == torch.float32 and torch.equal(q, qp) and torch.equal(m, mp)
        assert torch.equal(q, CP.quantize_color_gradient(x, 10.0))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("use_depth", [False, True], ids=["rgb", "rgbd"])
def test_trainer_on_the_card_equals_cpu(cuda, tmp_path, use_depth):
    """train_and_write on the card (K4, K1's magnitude variant) and on the
    CPU (their plain versions) at 160x120 on the cuboid: the templates YAML
    byte-identical; R, T, K, Ori_dist and Rect equal, D within 1e-6 m; one
    K4, two K1 and, with DepthNormal, one DN launch a chunk."""
    from linemod_pose_estimation_tpu_torch.models import templates as TT
    from linemod_pose_estimation_tpu_torch.models import trainer as TTR
    from linemod_pose_estimation_tpu_torch.utils import viewsphere as TV
    from linemod_pose_estimation_tpu_torch.utils.stl import save_binary_stl

    stl = str(tmp_path / "cuboid.stl")
    save_binary_stl(stl, S.cuboid_mesh().triangles)
    cfg = TTR.TrainerConfig(
        view_sphere=TV.ViewSphereParams(n_points=6, angle_step=120, radius_min=0.3,
                                        radius_max=0.5),
        width=160, height=120, focal_length_x=535.566011 / 4, focal_length_y=537.168115 / 4,
        render_batch=8, detector=TT.DetectorParams(use_depth_normal=use_depth))
    files = {}
    for dev in ("cpu", "cuda"):
        files[dev] = (str(tmp_path / f"{dev}_t.yml"), str(tmp_path / f"{dev}_p.yml"))
        tracing.reset()
        _, bank = TTR.train_and_write(stl, *files[dev], cfg, device=dev)
        if dev == "cuda":
            chunks = -(-len(TV.generate_views(cfg.view_sphere)) // cfg.render_batch)
            assert tracing.launches()["raster_zbuffer"] == chunks
            assert tracing.launches()["quantize_cg"] == 2 * chunks
            assert tracing.launches()["depth_normal"] == (chunks if use_depth else 0)
    assert bank.num_templates >= 8
    with open(files["cpu"][0], "rb") as a, open(files["cuda"][0], "rb") as b:
        assert a.read() == b.read()
    (pm, pg), (cm, cg) = (TemplateBank.read_params_yaml(files[d][1]) for d in ("cuda", "cpu"))
    for k in ("R", "T", "K", "Ori_dist", "Rect"):
        np.testing.assert_array_equal(getattr(pm, k), getattr(cm, k), err_msg=k)
    np.testing.assert_allclose(pm.D, cm.D, rtol=0, atol=1e-6)
    assert pg == cg


AUX_GOLDEN = "tests/data/torch_aux_golden.npz"


@pytest.mark.requires_cuda
def test_gather_engine_on_the_card_equals_golden(cuda):
    """Detector(engine="gather") over the full bank on the card: frames 0
    and 3's Matches equal the golden's (the reference's gather engine), and
    on frame 0's level-1 responses the gather scan, the convolution and
    the GEMM give equal scores; select_candidates_approx equals
    select_candidates."""
    bank = TemplateBank.read_templates_yaml(BANK)
    dets = {e: Detector(bank.params, device=cuda, engine=e) for e in ("gather", "auto")}
    for d in dets.values():
        d.attach_bank(bank)
    with np.load(CASCADE_GOLDEN) as z:
        g = {k: z[k] for k in z.files}
    cid, thr = bank.class_id, float(g["threshold"])
    for f in (0, 3):
        for d in dets.values():
            m = d.match_raw(g["rgb"][f], thr, depth_mm=g["depth_mm"][f])[cid]
            for name, x in m._asdict().items():
                np.testing.assert_array_equal(x.cpu().numpy(), g["m_" + name][f], err_msg=name)
    T1, Kc = bank.params.t_pyramid[1], bank.max_cell_extent(1)
    f1 = bank.merged_features(1).to(cuda)
    pyr = TM.preprocess_frame(torch.from_numpy(g["rgb"][0]).to(cuda),
                              torch.from_numpy(g["depth_mm"][0]).to(cuda), use_depth=True)
    R1 = torch.cat([pyr.grad_r1, pyr.norm_r1])
    raw = TM.coarse_scores(R1, f1, T1, Kc)
    assert torch.equal(TM.coarse_scores_conv(R1, bank.dense_weights(1).to(cuda), T1), raw)
    assert torch.equal(TM.coarse_scores_gemm(R1, dets["auto"]._exact_weights(cid), T1, Kc), raw)
    vpos = TM.position_validity(f1.size, T1, *raw.shape[1:])
    a = TM.select_candidates_approx(raw, f1.count, vpos, thr - 5.0, 512)
    b = TM.select_candidates(raw, f1.count, vpos, thr - 5.0, 512)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", ["view00", "view45", "roi"])
def test_grasp_segmentation_on_the_card(cuda, name):
    """The grasp planner and the segmentation ops on the card against the
    aux golden: the region and euclidean masks equal; the pose within 1e-3
    degrees and 1e-6 m, the smoothed points within 1e-6 m and the normals
    of the golden's smoothed points within 1e-5 (chip_smoke's GRASP_TOL)."""
    from linemod_pose_estimation_tpu_torch.models.grasp import grasping_pose_region_growing
    from linemod_pose_estimation_tpu_torch.ops import segmentation as SG
    from linemod_pose_estimation_tpu_torch.utils.geometry import rotation_geodesic_deg

    with np.load(AUX_GOLDEN) as z:
        a = {k: z[k] for k in z.files}
    if name == "roi":
        p, v = a["roi_pts"], a["roi_valid"]
    else:
        with np.load(f"data/sweep_{name}_clouds.npz") as z:
            p, v = z["scene"], z["svalid"]
    p, v = torch.from_numpy(p).to(cuda), torch.from_numpy(v).to(cuda)
    pose, region = grasping_pose_region_growing(p, v)
    assert np.array_equal(region.cpu().numpy(), a[f"{name}_region"])
    assert np.array_equal(SG.euclidean_cluster_largest(p, v, 0.005).cpu().numpy(),
                          a[f"{name}_euclid"])
    want = torch.from_numpy(a[f"{name}_pose"]).double()
    got = pose.cpu().double()
    assert float(rotation_geodesic_deg(got[:3, :3], want[:3, :3])) <= 1e-3
    assert float((got[:3, 3] - want[:3, 3]).norm()) <= 1e-6
    assert (a[f"{name}_support"][v.cpu().numpy()] >= 3).all()
    np.testing.assert_allclose(SG.mls_smooth(p, v).cpu().numpy(), a[f"{name}_mls"], atol=1e-6)
    n, _ = SG.estimate_normals(torch.from_numpy(a[f"{name}_mls"]).to(cuda), v, k=50)
    np.testing.assert_allclose(n.cpu().numpy(), a[f"{name}_normals"], atol=1e-5)


@pytest.mark.requires_cuda
def test_filters_on_the_card(cuda):
    """The aux filters on the card against the aux golden: HSV bit for bit
    on the golden frames and the seeded image, every gate, rect and keep
    mask equal."""
    import hashlib

    from linemod_pose_estimation_tpu_torch.ops import filters as FL

    with np.load(AUX_GOLDEN) as z:
        a = {k: z[k] for k in z.files}
    with np.load(CASCADE_GOLDEN) as z:
        rgb = z["rgb"]
    noise = np.random.default_rng(13).integers(0, 256, (480, 640, 3)).astype(np.uint8)
    imgs = [torch.from_numpy(x).to(cuda) for x in list(rgb) + [noise]]
    for f, img in enumerate(imgs):
        h = FL.rgb_to_hsv_u8(img).cpu().numpy()
        want = a["hsv_sha256"][f] if f < 4 else a["hsv_noise_sha256"]
        assert hashlib.sha256(h.tobytes()).digest() == want.tobytes(), f
    ranges = (((0.0, 180.0), (0.0, 255.0), (0.0, 255.0)),
              ((0.0, 30.0), (50.0, 255.0), (50.0, 255.0)),
              ((90.0, 150.0), (0.0, 255.0), (0.0, 255.0)),
              ((0.0, 180.0), (0.0, 20.0), (0.0, 222.0)))
    gate = [[bool(FL.hsv_color_filter(imgs[f], torch.from_numpy(r).to(cuda), *rg))
             for rg in ranges] for f, r in zip(a["gate_frame"], a["gate_rects"])]
    np.testing.assert_array_equal(gate, a["gate"])
    green = imgs[4][..., 1].float()
    got = [FL.absolute_rectangle(green, torch.from_numpy(r).to(cuda), 250.0).tolist()
           for r in a["gate_rects"][-64:]]
    np.testing.assert_array_equal(got, a["absrect_noise"])
    on = lambda x: torch.from_numpy(x).to(cuda)
    for i, s in enumerate((1, 3)):
        keep = FL.nms_distance(on(a["nms_cells"]), on(a["nms_scores"]), on(a["nms_valid"]), s)
        assert keep.device.type == "cuda"
        np.testing.assert_array_equal(keep.cpu().numpy(), a["nms_noise_keep"][i])


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    """The multi-device steps in 4 gloo ranks on cuda:0 (NCCL takes one
    rank per GPU), each kernel path beside its plain path: the 2x2 detect
    step in its four modes on the cascade frames over the RGB-D bank (the
    pooled one with the group tier), the row-sharded matcher over 2
    stripes of frame 0, the 4-rank ring."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    import pickle

    import _torch_sharded_ranks as RK
    from linemod_pose_estimation_tpu_torch.parallel import mesh as PM

    det = Detector.read(BANK, device="cpu")
    bank = det.bank(det.class_ids[0])
    T0, T1 = det.params.t_pyramid
    Kc1, E0, C = bank.max_cell_extent(1), bank.extent(0), 8 * bank.num_modalities
    f1 = tuple(a.numpy() for a in bank.merged_features(1))
    f0 = tuple(a.numpy() for a in bank.merged_features(0))
    with np.load(CASCADE_GOLDEN) as z:
        rgbs, deps = z["rgb"], z["depth_mm"]
    kw = dict(T1=T1, Kc1=Kc1, top_k=128, threshold=91.0, T0=T0, E0=E0)
    modes = {"pooled": dict(prune=True, prune_mode="pooled", pool_coarse=112, pool_fine=72),
             "positions": dict(prune=True, prune_mode="positions"),
             "two_axis": dict(prune=True, prune_mode="two_axis"),
             "exhaustive": dict(prune=False)}
    R0, R1 = TM.preprocess_frames_batched(torch.from_numpy(rgbs[:1]),
                                          torch.from_numpy(deps[:1]), use_depth=True)
    cases = []
    for plain in (False, True):
        tag = "_plain" * plain
        for mode, mkw in modes.items():
            cases.append((f"step_{mode}{tag}", "step", (2, 2), dict(
                rgbs=rgbs, depths=deps, feats1=f1, feats0=f0, put=True, device="cuda",
                bank_kw=dict(C=C, T1=T1, Kc1=Kc1, fine_g=4, group_bound=16),
                step_kw=dict(use_depth=True, plain=plain, **mkw, **kw))))
        cases.append((f"row{tag}", "row", (2, 2), dict(
            axis="bank", R1=R1[0].numpy(), R0=R0[0].numpy(), feats1=f1, feats0=f0, C=C,
            T1=T1, Kc1=Kc1, device="cuda",
            mkw=dict(top_k=128, threshold=91.0, T0=T0, E0=E0, plain=plain))))
        cases.append((f"ring{tag}", "ring", (1, 4), dict(
            axis="bank", rgbs=rgbs, depths=deps, feats1=f1, feats0=f0, C=C, T1=T1,
            Kc1=Kc1, device="cuda", skw=dict(top_k=128, threshold=91.0, T0=T0, E0=E0,
                                             use_depth=True, plain=plain))))
    d = tmp_path_factory.mktemp("sharded_cuda")
    PM.spawn(RK.run_cases, 4, "gloo", str(d / "rendezvous"), args=(cases, str(d), "cuda"),
             timeout_s=300.0)

    def load(name):
        out = []
        for r in range(4):
            with open(d / f"{name}_{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out

    return load


@pytest.mark.requires_cuda
@pytest.mark.parametrize("mode", ["pooled", "positions", "two_axis", "exhaustive"])
def test_sharded_detect_step_kernels_equal_plain(sharded_runs, mode):
    for r, (k, p) in enumerate(zip(sharded_runs(f"step_{mode}"),
                                   sharded_runs(f"step_{mode}_plain"))):
        for name in k["matches"]:
            np.testing.assert_array_equal(k["matches"][name], p["matches"][name],
                                          err_msg=f"rank {r} {name}")
        assert k["metrics"] == p["metrics"]
        assert int(k["metrics"]["num_matches"]) > 0
        if mode == "pooled":
            assert k["grouped_calls"] == 1 and not k["pool"]["fallback"]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("step", ["row", "ring"])
def test_row_and_ring_kernels_equal_plain(sharded_runs, step):
    found = 0
    for r, (k, p) in enumerate(zip(sharded_runs(step), sharded_runs(f"{step}_plain"))):
        km = k["matches"] if step == "ring" else k
        pm = p["matches"] if step == "ring" else p
        for name in km:
            np.testing.assert_array_equal(km[name], pm[name], err_msg=f"rank {r} {name}")
        found += int(km["valid"].sum())
    assert found > 0  # the ring's rank 3 holds the background frame: none there
