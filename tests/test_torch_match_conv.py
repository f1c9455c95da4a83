"""PyTorch port vs the JAX reference: the off-main-path scorers of
ops/match.py (linearize_responses, coarse_scores, build_dense_weights,
coarse_scores_conv, select_candidates_approx), TemplateBank.dense_weights
and Detector(engine=...), on CPU.

Inputs: the seeded banks and response maps of tests/test_match_conv.py
(its conv, gather and dense-weight cases through both packages, with
duplicated features, offsets past the cell extent and orientations past
the channels), a bank subset of data/boxNew_rgbd_templates.yml.gz on a
cascade golden frame, the detector tests/test_serving.py builds, and the
full bank on the cascade golden frames (tests/data/torch_cascade_golden.
npz, whose Matches the reference's gather engine made).

Tolerance: exact equality of every output (integer scores and weights,
candidates, Matches).
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _xdist_threads  # noqa: F401  (PyTorch threads per xdist worker)

from linemod_pose_estimation_tpu.models.detector import Detector as JDetector
from linemod_pose_estimation_tpu.models.templates import DetectorParams as JParams
from linemod_pose_estimation_tpu.models.templates import TemplateBank as JBank
from linemod_pose_estimation_tpu.ops import match as JM
from linemod_pose_estimation_tpu_torch import convert
from linemod_pose_estimation_tpu_torch.models.detector import Detector
from linemod_pose_estimation_tpu_torch.models.templates import DetectorParams, TemplateBank
from linemod_pose_estimation_tpu_torch.ops import match as TM

BANK = "data/boxNew_rgbd_templates.yml.gz"
GOLDEN = "tests/data/torch_cascade_golden.npz"
t = lambda a: torch.from_numpy(np.array(a))
j = jnp.asarray


def random_bank(rng, n, fmax=24, extent=30, dup=True):
    """(JAX LevelFeatures, port LevelFeatures) of a seeded bank; with
    `dup`, every third template repeats its first feature."""
    offs = rng.integers(0, extent, size=(n, fmax, 2)).astype(np.int32)
    oris = rng.integers(0, 8, size=(n, fmax)).astype(np.int32)
    if dup:
        offs[::3, 1], oris[::3, 1] = offs[::3, 0], oris[::3, 0]
    cnt = rng.integers(4, fmax + 1, size=(n,)).astype(np.int32)
    live = np.arange(fmax)[None, :] < cnt[:, None]
    size = np.full((n, 2), extent, np.int32)
    fields = (offs, oris, live, cnt, size)
    return (JM.LevelFeatures(*map(j, fields)),
            convert.level_features_from_numpy(*fields, device="cpu"))


def random_R(rng, c, h, w):
    return rng.choice([0, 3, 4], size=(c, h, w)).astype(np.uint8)


def assert_eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("T,Kc", [(8, 4), (5, 6), (8, 2), (8, 1)])
def test_linearize_and_gather(rng, T, Kc):
    """Kc 4 and 6 cover the offsets; 2 and 1 do not, and the reference's
    dynamic_slice clamps the cell shift to [0, Kc]."""
    jf, tf = random_bank(rng, 17)
    R = random_R(rng, 8, 72, 96)
    assert_eq(TM.linearize_responses(t(R), T, Kc), JM.linearize_responses(j(R), T, Kc))
    assert_eq(TM.coarse_scores(t(R), tf, T, Kc), JM.coarse_scores(j(R), jf, T, Kc))


def test_gather_clamps_the_plane(rng):
    """Orientations past the channels address planes past C*T*T, clamped to
    the last one as dynamic_slice clamps."""
    jf, tf = random_bank(rng, 9)
    oris = np.asarray(jf.oris).copy()
    oris[:, :3] = 11
    jf, tf = jf._replace(oris=j(oris)), tf._replace(oris=t(oris))
    R = random_R(rng, 8, 64, 64)
    assert_eq(TM.coarse_scores(t(R), tf, 8, 4), JM.coarse_scores(j(R), jf, 8, 4))


def test_conv_coarse_equals_gather(rng):
    T, ext_px = 8, 30
    jf, tf = random_bank(rng, 17)
    R = random_R(rng, 8, 72, 96)
    ref = TM.coarse_scores(t(R), tf, T, ext_px // T + 1)
    W = TM.build_dense_weights(tf, 8, 32)
    assert_eq(W, JM.build_dense_weights(jf, 8, 32))
    got = TM.coarse_scores_conv(t(R), W, T)
    assert got.dtype == torch.int32
    assert_eq(got, ref.numpy())
    assert_eq(got, JM.coarse_scores_conv(j(R), JM.build_dense_weights(jf, 8, 32), T))


@pytest.mark.parametrize("engine", ["conv", "gemm"])
def test_coarse_merged_modalities(rng, engine):
    (jg, tg), (jn, tn) = random_bank(rng, 9), random_bank(rng, 9)
    Rg, Rn = random_R(rng, 8, 64, 64), random_R(rng, 8, 64, 64)
    jmerged, jR = JM.merge_modalities([jg, jn], [j(Rg), j(Rn)])
    merged, R = TM.merge_modalities([tg, tn], [t(Rg), t(Rn)])
    ref = JM.coarse_scores(jR, jmerged, 8, 5)
    assert_eq(TM.coarse_scores(R, merged, 8, 5), ref)
    if engine == "conv":
        got = TM.coarse_scores_conv(R, TM.build_dense_weights(merged, 16, 32), 8)
    else:
        W = TM.exact_weights(merged, 16, 8, 5)
        got = TM.coarse_scores_gemm(R, W, 8, 5)
    assert_eq(got, ref)


def test_gemm_coarse_equals_gather(rng):
    T = 8
    jf, tf = random_bank(rng, 17, fmax=24, extent=30)
    R = random_R(rng, 8, 72, 96)
    Kc = 30 // T + 1
    W = TM.exact_weights(tf, 8, T, Kc)
    assert_eq(TM.coarse_scores_gemm(t(R), W, T, Kc), JM.coarse_scores(j(R), jf, T, Kc))


def test_dense_weights_structure(rng):
    """Each live feature adds one (duplicates keep their multiplicity),
    offsets past E - 1 clip to it."""
    jf, tf = random_bank(rng, 6, fmax=8, extent=20)
    W = TM.build_dense_weights(tf, 8, 16)
    assert W.dtype == torch.int8 and W.shape == (6, 8, 16, 16)
    assert_eq(W, JM.build_dense_weights(jf, 8, 16))
    Wn = W.numpy()
    for n in range(6):
        cnt = int(tf.count[n])
        for f in range(cnt):
            o, y, x = int(tf.oris[n, f]), *(min(int(v), 15) for v in tf.offsets[n, f])
            assert Wn[n, o, y, x] >= 1
        assert Wn[n].sum() == cnt
    assert Wn[0].max() >= 2  # the duplicated feature


def test_select_candidates_approx_ties():
    """Ties take the lower flat (template-major) index: scores [1,5,5,3,5,0]
    give indices [1, 2, 4], as the reference's approx_max_k does on its CPU
    backend."""
    raw = np.array([1, 5, 5, 3, 5, 0], np.int32).reshape(2, 1, 3)
    count = np.array([1, 1], np.int32)
    vpos = np.ones((2, 1, 3), bool)
    want = JM.select_candidates_approx(j(raw), j(count), j(vpos), 125.0, 3)
    got = TM.select_candidates_approx(t(raw), t(count), t(vpos), 125.0, 3)
    for name, a, b in zip(want._fields, got, want):
        assert_eq(a, b)
    flat = got.template_id * 3 + got.cell_x
    assert flat.tolist() == [1, 2, 4] and got.valid.tolist() == [True, True, True]


def test_select_candidates_approx_seeded(rng):
    N, Hc, Wc = 12, 7, 9
    raw = rng.integers(0, 40, (N, Hc, Wc)).astype(np.int32)
    count = rng.integers(0, 12, N).astype(np.int32)
    vpos = rng.random((N, Hc, Wc)) < 0.8
    want = JM.select_candidates_approx(j(raw), j(count), j(vpos), 300.0, 64)
    got = TM.select_candidates_approx(t(raw), t(count), t(vpos), 300.0, 64)
    for name, a, b in zip(want._fields, got, want):
        assert_eq(a, b)


# -- banks and the Detector ---------------------------------------------------


@pytest.fixture(scope="module")
def subset():
    """(JAX bank, port bank) of every 97th template of the real bank."""
    jd = JDetector.read(BANK)
    jb = jd.bank(jd.class_ids[0])
    jsub = JBank(jb.class_id, jb.params, jb.templates[::97])
    return jsub, convert.detector_from_reference(jsub, device="cpu").bank(jb.class_id)


@pytest.mark.parametrize("level", [0, 1])
def test_bank_dense_weights(subset, level):
    jb, tb = subset
    W = tb.dense_weights(level)
    assert W is tb.dense_weights(level)  # cached
    assert W.shape == (tb.num_templates, 16, tb.extent(level), tb.extent(level))
    assert_eq(W, jb.dense_weights(level))


def test_coarse_engines_on_a_golden_frame(subset):
    """The three coarse scorers on frame 0's level-1 response stack (both
    modalities) agree bitwise, and with the reference's gather scan."""
    jb, tb = subset
    with np.load(GOLDEN) as z:
        rgb, dep = z["rgb"][0], z["depth_mm"][0]
    pyr = TM.preprocess_frame(t(rgb), t(dep), use_depth=True)
    R1 = torch.cat([pyr.grad_r1, pyr.norm_r1])
    f1, Kc = tb.merged_features(1), tb.max_cell_extent(1)
    gather = TM.coarse_scores(R1, f1, 8, Kc)
    assert_eq(gather, JM.coarse_scores(j(R1.numpy()), jb.merged_features(1), 8, Kc))
    assert_eq(TM.coarse_scores_conv(R1, tb.dense_weights(1), 8), gather.numpy())
    W = TM.exact_weights(f1, 16, 8, Kc)
    assert_eq(TM.coarse_scores_gemm(R1, W, 8, Kc), gather.numpy())
    assert int(gather.max()) > 0


@pytest.fixture(scope="module")
def serving_detectors():
    """The detector tests/test_serving.py builds: one template of a
    textured disk, both packages; and its frames."""
    sys.path.insert(0, "tests")
    from test_match import make_object_patch, plant

    patch, mask = make_object_patch(np.random.default_rng(0))
    src = plant((120, 160, 3), patch, (30, 50))
    src_mask = plant((120, 160), mask, (30, 50))
    jd = JDetector(JParams(), engine="gather")
    assert jd.add_template(src, src_mask, "obj") == 0
    frames = [src, plant((120, 160, 3), patch, (44, 62)), np.zeros_like(src)]
    return jd, (src, src_mask), frames


@pytest.mark.parametrize("engine", ["gather", "conv", "auto", "other"])
def test_detector_engines(serving_detectors, engine):
    """Detector(DetectorParams(), engine=...) built as tests/test_serving.py
    builds the reference's: every engine's Matches equal the reference's
    gather engine's on every slot ("other" takes the gather branch, as
    the reference's `else` does)."""
    jd, (src, src_mask), frames = serving_detectors
    td = Detector(DetectorParams(), engine=engine, device="cpu")
    assert td.engine == engine
    assert td.add_template(src, src_mask, "obj") == 0
    for rgb in frames:
        want = jd.match_raw(rgb, 90.0, top_k=16)["obj"]
        got = td.match_raw(rgb, 90.0, top_k=16)["obj"]
        for name, a, b in zip(want._fields, got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert int(got.valid.sum()) == 0 and int(want.valid.sum()) == 0  # the empty frame
    assert (td._exact == {}) == (engine in ("gather", "other"))


@pytest.mark.parametrize("frame", [0, 3])
def test_gather_engine_full_width_against_golden(frame):
    """The gather engine over the full 2652-template bank at 640x480: the
    golden's Matches (the reference's gather engine) on every slot."""
    with np.load(GOLDEN) as z:
        g = {k: z[k][frame] for k in ("rgb", "depth_mm", "m_template_id", "m_x", "m_y",
                                        "m_similarity", "m_valid")}
        thr = float(z["threshold"])
    bank = TemplateBank.read_templates_yaml(BANK)
    det = Detector(bank.params, engine="gather", device="cpu")
    det.attach_bank(bank)
    m = det.match_raw(g["rgb"], thr, depth_mm=g["depth_mm"])[det.class_ids[0]]
    for name in m._fields:
        np.testing.assert_array_equal(getattr(m, name).numpy(), g["m_" + name], err_msg=name)
    assert int(m.valid.sum()) == (4 if frame == 0 else 0)
