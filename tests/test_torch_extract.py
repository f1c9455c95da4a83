"""Template extraction in the port (``models/templates.py``: the scattered
selection, extract_template, quantize_levels; ``Detector.add_template``;
the trainer's per-chunk host step ``trainer.add_views``) against the JAX
reference, on the CPU, with the committed renders of
``tests/data/render_cache`` (seven at 640x480, four at 320x240, ten at
160x120) and seeded candidate sets.

Tolerances: none — every feature row, size and rect0 is equal, in both
modes (ColorGradient alone, and with DepthNormal); the selection keeps the
same candidates in the same order; the render dump is byte-identical.
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _xdist_threads  # noqa: F401  (PyTorch threads per xdist worker)

from linemod_pose_estimation_tpu.models import templates as JT
from linemod_pose_estimation_tpu.models import trainer as JTR
from linemod_pose_estimation_tpu.models.detector import Detector as JDetector
from linemod_pose_estimation_tpu_torch.models import templates as TT
from linemod_pose_estimation_tpu_torch.models import trainer as TTR
from linemod_pose_estimation_tpu_torch.models.detector import Detector as TDetector
from linemod_pose_estimation_tpu_torch.models.renderer import RenderOutput

CACHE = os.path.join(os.path.dirname(__file__), "data", "render_cache")


def renders(size):
    """The committed renders of one size, (W, H): (rgb, depth_mm f32, mask, rect)."""
    out = []
    for f in sorted(glob.glob(os.path.join(CACHE, "*.npz"))):
        with np.load(f) as z:
            if z["rgb"].shape[:2] == size[::-1]:
                out.append((z["rgb"].copy(), z["depth_mm"].astype(np.float32),
                            z["mask"].copy(), z["rect"].astype(np.int32)))
    return out


def params_pair(use_depth: bool):
    return (JT.DetectorParams(use_depth_normal=use_depth),
            TT.DetectorParams(use_depth_normal=use_depth))


def assert_same_template(j, t, what=""):
    assert (j is None) == (t is None), what
    if j is None:
        return
    for name in ("grad", "norm"):
        a, b = getattr(j, name), getattr(t, name)
        assert len(a) == len(b), (what, name)
        for l, (fa, fb) in enumerate(zip(a, b)):
            assert fb.dtype == np.int32, (what, name, l)
            np.testing.assert_array_equal(fb, fa, err_msg=f"{what} {name} level {l}")
    assert list(t.size) == list(j.size), what
    assert tuple(t.rect0) == tuple(j.rect0), what


# -- the scattered selection ------------------------------------------------


def candidate_set(kind: str, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "dense":  # a whole-mask interior, as DepthNormal's candidates are
        h, w = rng.integers(40, 140, size=2)
        ys, xs = np.mgrid[0:h, 0:w]
        cand = np.stack([ys.ravel() + 50, xs.ravel() + 70,
                         rng.integers(0, 8, size=h * w)], 1).astype(np.int32)
        # border distances: few distinct values, many ties
        scores = np.minimum(np.minimum(ys, h - 1 - ys), np.minimum(xs, w - 1 - xs)).ravel()
        return cand, scores.astype(np.float64)
    n = int(rng.integers(40, 3000))
    cand = np.stack([rng.integers(0, 480, n), rng.integers(0, 640, n),
                     rng.integers(0, 8, n)], 1).astype(np.int32)
    if kind == "ties":  # magnitudes from a handful of values
        scores = rng.choice([3026.0, 5000.0, 5000.0, 12000.0], size=n).astype(np.float32)
    else:
        scores = rng.uniform(3025, 2e6, n).astype(np.float32)
    return cand, scores


@pytest.mark.parametrize("kind", ["dense", "ties", "sparse"])
@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("num", [63, 7])
def test_select_scattered_equals_reference(kind, seed, num):
    cand, scores = candidate_set(kind, seed)
    np.testing.assert_array_equal(TT._select_scattered(cand, scores, num),
                                  JT._select_scattered(cand, scores, num))
    order = np.argsort(-scores, kind="stable")
    np.testing.assert_array_equal(TT._select_from_sorted(cand[order], num),
                                  JT._select_from_sorted(cand[order], num))


def test_select_small_and_empty_sets():
    for n in (0, 1, 5, 31, 32):
        cand, scores = candidate_set("sparse", n)
        cand, scores = cand[:n], scores[:n]
        np.testing.assert_array_equal(TT._select_scattered(cand, scores, 63),
                                      JT._select_scattered(cand, scores, 63))


def test_bit_to_index_equals_reference():
    q = (1 << np.random.default_rng(0).integers(0, 8, size=(37, 41))).astype(np.uint8)
    np.testing.assert_array_equal(TT._bit_to_index(q), JT._bit_to_index(q))


# -- extract_template -------------------------------------------------------


@pytest.mark.parametrize("size", [(640, 480), (320, 240), (160, 120)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("use_depth", [False, True], ids=["rgb", "rgbd"])
def test_extract_template_equals_reference(size, use_depth):
    jp, tp = params_pair(use_depth)
    views = renders(size)
    assert len(views) == {640: 7, 320: 4, 160: 10}[size[0]]
    kept = 0
    for i, (rgb, dep, mask, _) in enumerate(views):
        j = JT.extract_template(rgb, dep, mask, jp)
        t = TT.extract_template(rgb, dep, mask, tp, device="cpu")
        assert_same_template(j, t, f"view {i}")
        kept += t is not None
    assert kept > 0


def test_quantize_levels_equals_the_reference_featurizer():
    """The device half of the trainer (level 0 on u8, level 1 on the
    pyrDown, DepthNormal once) against the reference's full-frame
    quantizers: bit for bit, both levels."""
    from linemod_pose_estimation_tpu.ops import features as JF

    views = renders((320, 240))
    rgb = np.stack([v[0] for v in views])
    dep = np.stack([v[1] for v in views])
    tp = TT.DetectorParams(use_depth_normal=True)
    grad, norm = TT.quantize_levels(torch.from_numpy(rgb), torch.from_numpy(dep), tp)
    for b in range(len(views)):
        cur = rgb[b].astype(np.float32)
        qn = np.asarray(JF.quantize_depth_normal(jnp.asarray(dep[b]), 2000.0, 50.0))
        for l in range(2):
            q, m2 = JF.quantize_color_gradient(jnp.asarray(cur), 10.0)
            np.testing.assert_array_equal(grad[l][0][b].numpy(), np.asarray(q))
            np.testing.assert_array_equal(grad[l][1][b].numpy(), np.asarray(m2))
            np.testing.assert_array_equal(norm[l][b].numpy(), qn)
            cur = np.stack([JT._pyr_down_np(cur[..., c]) for c in range(3)], -1)
            qn = qn[::2, ::2]


def _reference_chunk(views, jp, class_id="obj"):
    """The reference trainer's per-chunk path on these renders:
    _featurize_batch's 288-px crops (or the full-frame branch past
    CROP - 24), add_template with the precomputed crops, rect0 re-based."""
    H, W = views[0][0].shape[:2]
    crop = min(288, W, H)
    rgbs, deps, masks, rects = (np.stack([v[k] for v in views]) for k in range(4))
    feat = JTR._featurize_batch(
        jnp.asarray(rgbs), jnp.asarray(deps), jnp.asarray(masks), jnp.asarray(rects),
        jp.color.weak_threshold, jp.depth.distance_threshold, jp.depth.difference_threshold,
        use_depth=jp.use_depth_normal, levels=jp.pyramid_levels, crop=crop)
    feat = {k: [np.asarray(a) for a in v] if isinstance(v, list) else np.asarray(v)
            for k, v in feat.items()}
    det = JDetector(jp)
    tids = []
    for j in range(len(views)):
        if rects[j, 2] == 0 or rects[j, 3] == 0:
            tids.append(-1)
            continue
        if rects[j, 2] > crop - 24 or rects[j, 3] > crop - 24:
            tid = det.add_template(rgbs[j], masks[j], class_id,
                                   depth_mm=deps[j] if jp.use_depth_normal else None)
        else:
            pre = {"grad": [(u8[j, 0], m2[j]) for u8, m2 in zip(feat["u8"], feat["f32"])],
                   "norm": [u8[j, 1] for u8 in feat["u8"]] if jp.use_depth_normal else []}
            tid = det.add_template(np.zeros((crop, crop, 3), np.uint8), feat["u8"][0][j, -1],
                                   class_id, depth_mm=(np.zeros((crop, crop), np.uint16)
                                                       if jp.use_depth_normal else None),
                                   precomputed=pre)
            if tid >= 0:
                t = det._templates[class_id][tid]
                x0, y0, w0, h0 = t.rect0
                t.rect0 = (x0 + int(feat["meta"][j, 1]), y0 + int(feat["meta"][j, 0]), w0, h0)
        tids.append(tid)
    return det, tids


@pytest.mark.parametrize("size", [(640, 480), (160, 120)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("use_depth", [False, True], ids=["rgb", "rgbd"])
def test_trainer_host_step_equals_the_reference_chunk(size, use_depth):
    """The same renders through both trainers' chunk paths (the reference's
    _featurize_batch + add_template on 288-px crops; the port's
    chunk_arrays + add_views on windows of the full frame), plus an empty
    render: the same template ids, features, sizes and rect0."""
    jp, tp = params_pair(use_depth)
    views = renders(size)
    H, W = size[::-1]
    views.append((np.zeros((H, W, 3), np.uint8), np.zeros((H, W), np.float32),
                  np.zeros((H, W), np.uint8), np.zeros(4, np.int32)))
    jdet, jtids = _reference_chunk(views, jp)
    out = RenderOutput(*(torch.from_numpy(np.stack([v[k] for v in views])) for k in (1, 2, 0, 3)))
    tdet = TDetector(tp, device="cpu")
    ttids = TTR.add_views(tdet, "obj", [a.numpy() for a in TTR.chunk_arrays(out, tp)])
    assert ttids == jtids and ttids[-1] == -1
    assert tdet.num_templates("obj") == jdet.num_templates("obj") > 0
    for i, (a, b) in enumerate(zip(jdet._templates["obj"], tdet._templates["obj"])):
        assert_same_template(a, b, f"template {i}")


def test_window_reaches_the_frame_edges():
    """A view at the frame's corner: the host window runs to the edge."""
    assert TTR._window((0, 0, 10, 10), 120, 160) == (0, 0, 12, 12)
    assert TTR._window((150, 111, 10, 9), 120, 160) == (108, 148, None, None)
    assert TTR._window((151, 3, 7, 9), 120, 160)[1] == 148
    s = TTR._level_slice((110, 148, None, 13), 1)
    assert s == np.s_[55:None, 74:7]


# -- Detector.add_template --------------------------------------------------


@pytest.mark.parametrize("use_depth", [False, True], ids=["rgb", "rgbd"])
def test_add_template_and_bank_follow_the_reference(use_depth):
    jp, tp = params_pair(use_depth)
    jd, td = JDetector(jp), TDetector(tp, device="cpu")
    views = renders((320, 240))
    H, W = 240, 320
    flat = (np.full((H, W, 3), 90, np.uint8), np.full((H, W), 700.0, np.float32),
            np.full((H, W), 255, np.uint8))
    for rgb, dep, mask in [v[:3] for v in views] + [flat]:
        for cid in ("a", "b"):
            a = jd.add_template(rgb, mask, cid, depth_mm=dep if use_depth else None)
            b = td.add_template(rgb, mask, cid, depth_mm=dep if use_depth else None)
            assert a == b
    assert b == -1  # the featureless view: addTemplate fails
    n = jd.num_templates("a")
    assert n >= 2
    assert td.class_ids == jd.class_ids == ["a", "b"]
    assert td.num_templates("a") == n and td.num_templates() == jd.num_templates() == 2 * n
    assert td.num_templates("missing") == 0
    for i in range(n):
        assert td.template_rect0("b", i) == jd.template_rect0("b", i)
    tb = td.bank("a")
    assert tb is td.bank("a") and tb.num_templates == n
    for l in range(2):
        for k, lf in jd.bank("a").levels[l].items():
            for f in ("offsets", "oris", "live", "count", "size"):
                np.testing.assert_array_equal(getattr(tb.levels[l][k], f).numpy(),
                                              np.asarray(getattr(lf, f)))
    # adding drops the built bank (and its device operands)
    td._operands["a"] = ("stale",)
    rgb, dep, mask, _ = renders((640, 480))[0]
    assert td.add_template(rgb, mask, "a", depth_mm=dep if use_depth else None) == n
    assert "a" not in td._operands and td.bank("a") is not tb
    assert td.bank("a").num_templates == n + 1


def test_add_template_without_depth_fails_in_the_depth_mode():
    _, tp = params_pair(True)
    rgb, _, mask, _ = renders((320, 240))[0]
    assert TDetector(tp, device="cpu").add_template(rgb, mask) == -1
    assert JDetector(JT.DetectorParams(use_depth_normal=True)).add_template(rgb, mask) == -1


def test_add_template_defaults_to_the_card():
    import inspect

    assert inspect.signature(TT.extract_template).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TDetector()


# -- the render dump --------------------------------------------------------


def test_render_dump_round_trip_and_bytes(tmp_path):
    views = renders((160, 120))[:3]
    deps = [np.round(v[1]).astype(np.uint16) for v in views]
    masks = [v[2] for v in views]
    rects = [tuple(int(x) for x in v[3]) for v in views]
    tp, jp = str(tmp_path / "t.yml"), str(tmp_path / "j.yml")
    TT.TemplateBank.write_render_dump(tp, deps, masks, rects)
    JT.TemplateBank.write_render_dump(jp, deps, masks, rects)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    back = TT.TemplateBank.read_render_dump(tp)
    jback = JT.TemplateBank.read_render_dump(tp)
    assert len(back) == len(jback) == 3
    for (d, m, r), (jd, jm, jr), d0, m0, r0 in zip(back, jback, deps, masks, rects):
        assert d.dtype == np.uint16 and m.dtype == np.uint8
        np.testing.assert_array_equal(d, d0)
        np.testing.assert_array_equal(m, m0)
        np.testing.assert_array_equal(jd, d0)
        assert r == jr == r0
