"""The CUDA kernels K1, K2 (also at B=1, the port of K2b), K3, K4, K5 and
the kernel paths of BatchedMatcher, the K5 refiner,
MultiClassBatchedMatcher and DetectionPipeline against their plain
PyTorch versions, on a card.  Every test here is
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
    BatchedMatcher, MultiClassBatchedMatcher)
from linemod_pose_estimation_tpu_torch.models.templates import TemplateBank
from linemod_pose_estimation_tpu_torch.ops import _build
from linemod_pose_estimation_tpu_torch.ops import cuda_kernels as CK
from linemod_pose_estimation_tpu_torch.ops import cuda_preprocess as CP
from linemod_pose_estimation_tpu_torch.ops import features as TF
from linemod_pose_estimation_tpu_torch.ops import match as TM
from linemod_pose_estimation_tpu_torch.ops import raster as RA
from linemod_pose_estimation_tpu_torch.utils import kernel_cases as KC
from linemod_pose_estimation_tpu_torch.utils import pointcloud as TP
from linemod_pose_estimation_tpu_torch.utils import scenes as S

BANK = "data/boxNew_rgbd_templates.yml.gz"
PARAMS = "data/boxNew_rgbd_params.yml.gz"
CASCADE_GOLDEN = "tests/data/torch_cascade_golden.npz"



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
    _build.reset_launch_counts()
    got = TM.refine_candidates_pallas_batched(R0, m.feats0, cands, m.T1, 70.0, m.E0,
                                              fine_T=m.T0)
    assert _build.launch_counts["refine_scores"] == 1
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


@pytest.mark.requires_cuda
def test_detect_on_the_card_launches_every_kernel(cuda):
    """DetectionPipeline.detect at full width on golden frame 0: Matches
    equal to the JAX reference's, a detection, and K1-K4 launched."""
    with np.load(CASCADE_GOLDEN) as z:
        g = {k: z[k] for k in z.files}
    pipe = DetectionPipeline.from_files(BANK, PARAMS, S.cuboid_mesh(), device=cuda)
    dep = torch.from_numpy(g["depth_mm"][0]).to(cuda)
    cloud = TP.depth_to_cloud(TP.true_div(dep, 1000.0), pipe.K_render)
    _build.reset_launch_counts()
    dets, st = pipe.detect(g["rgb"][0], cloud, threshold=float(g["threshold"]),
                           depth_mm=dep, return_stages=True)
    for name, a in st.matches._asdict().items():
        np.testing.assert_array_equal(a.cpu().numpy(), g["m_" + name][0], err_msg=name)
    assert len(dets) >= 1
    for k in ("quantize_cg", "spread_response", "walk_scores", "raster_zbuffer"):
        assert _build.launch_counts[k] > 0, k
