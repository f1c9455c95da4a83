"""The port's accuracy harness (``linemod_pose_estimation_tpu_torch/eval.py``)
against the JAX package's ``eval.py``, on the CPU, on banks the port's
trainer makes from the cuboid stand-in for the boxNew STL (views at 0.5 m:
all 8 at 160x120 with the focal lengths / 4 for the matcher and the pose;
the first 3 at 320x240 with them / 2 where cv::linemod is the referee: its
pyramid needs sides divisible by 5 and 16).  Each harness gets its own package's
detector, renderer and pipeline, holding the same templates, and the same
views.  The detectors hold the trained templates in memory (the YAML
schema has no template origin: a bank read from its file reports its
matches against origin (0, 0)); the two read back from the file are
compared with each other.

Tolerances:
- evaluate_match_px: every case equal (found, px_err, px_err_tie, score);
  the reference's own bars (found rate 1, px error max <= 2.9, score p50
  >= 99) hold;
- evaluate_pose: found equal; degrees within 0.25, centimetres within
  0.05 (the CPU detect tolerance of tests/test_torch_cascade.py: the JAX
  CPU render contracts its products into FMAs);
- make_ab_scenes: the same scenes from the same seed (rgb, truths and
  categories equal; depth within 1e-3 mm, the rasterizers' depth
  difference);
- evaluate_vs_opencv / evaluate_bank_ab: the reports equal the reference
  harness's (skipped where the cv::linemod oracle cannot build).
"""

import json

import numpy as np
import pytest

import _xdist_threads  # noqa: F401  (PyTorch threads per xdist worker)

from linemod_pose_estimation_tpu import eval as JEV
from linemod_pose_estimation_tpu.models import cascade as JC
from linemod_pose_estimation_tpu.models.detector import Detector as JDetector
from linemod_pose_estimation_tpu.models.pipeline import DetectionPipeline as JPipe
from linemod_pose_estimation_tpu.models.renderer import Renderer as JRenderer
from linemod_pose_estimation_tpu.models.templates import DetectorParams as JDetectorParams
from linemod_pose_estimation_tpu.models.templates import TemplateBank as JBank
from linemod_pose_estimation_tpu.models.templates import TemplateFeatures as JTemplateFeatures
from linemod_pose_estimation_tpu_torch import eval as TEV
from linemod_pose_estimation_tpu_torch.models import cascade as TC
from linemod_pose_estimation_tpu_torch.models import templates as TT
from linemod_pose_estimation_tpu_torch.models import trainer as TTR
from linemod_pose_estimation_tpu_torch.models.detector import Detector as TDetector
from linemod_pose_estimation_tpu_torch.models.pipeline import DetectionPipeline as TPipe
from linemod_pose_estimation_tpu_torch.models.renderer import Renderer as TRenderer
from linemod_pose_estimation_tpu_torch.utils import oracle as TORC
from linemod_pose_estimation_tpu_torch.utils import viewsphere as TV
from linemod_pose_estimation_tpu_torch.utils.scenes import cuboid_mesh
from linemod_pose_estimation_tpu_torch.utils.stl import save_binary_stl

DEG_TOL, CM_TOL = 0.25, 0.05
SPHERE = dict(n_points=4, angle_step=180, radius_min=0.5, radius_max=0.5)
CASCADE = dict(canonicalize="none", max_clusters=2, model_cap=512, scene_cap=512,
               icp_max_iter=40, cluster_filter_thresh=0)
FIELDS = ("view_id", "found", "px_err", "px_err_tie", "deg_err", "cm_err", "score")
# The JAX Renderer.render as the module defines it: tests/conftest.py wraps
# it in a disk cache for the session (after collection, when this runs), and
# these views would add files to the committed tests/data/render_cache.
_JAX_RENDER = JRenderer.render


class LiveJaxRenderer(JRenderer):
    """The JAX renderer without the suite's disk cache."""

    def render(self, R, T_bank):
        return _JAX_RENDER(self, R, T_bank)


def _train(tmp, stl, div: int, use_depth: bool):
    """The port's trainer at (640/div)x(480/div) (3 views at 320x240, where
    the CPU rasterizer takes seconds a view): its detector and a reference
    detector holding the same templates; both packages' detectors read
    from the bank file it writes, both renderers, the params."""
    W, H = 640 // div, 480 // div
    fx, fy = 535.566011 / div, 537.168115 / div
    cfg = TTR.TrainerConfig(view_sphere=TV.ViewSphereParams(**SPHERE), width=W, height=H,
                            focal_length_x=fx, focal_length_y=fy, render_batch=4,
                            detector=TT.DetectorParams(use_depth_normal=use_depth))
    tag = f"{W}_{'rgbd' if use_depth else 'rgb'}"
    tyml, pyml = str(tmp / f"{tag}_t.yml"), str(tmp / f"{tag}_p.yml")
    tdet, bank = TTR.train_and_write(stl, tyml, pyml, cfg, max_views=8 if div == 4 else 3,
                                     device="cpu")
    assert bank.num_templates >= 3
    jdet = JDetector(JDetectorParams(use_depth_normal=use_depth))
    jdet.attach_bank(JBank(bank.class_id, jdet.params, [
        JTemplateFeatures(grad=t.grad, norm=t.norm, size=t.size, rect0=t.rect0)
        for t in bank.templates]))
    return dict(
        W=W, H=H, tdet=tdet, jdet=jdet, jdet_file=JDetector.read(tyml), bank=bank,
        tparams=TT.TemplateBank.read_params_yaml(pyml), jparams=JBank.read_params_yaml(pyml),
        trend=TRenderer(stl, W, H, fx, fy, device="cpu"),
        jrend=LiveJaxRenderer(stl, W, H, fx, fy),
        tdet_file=TDetector.read(tyml, device="cpu"))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eval")
    stl = str(tmp / "cuboid.stl")
    save_binary_stl(stl, cuboid_mesh().triangles)
    cache = {}

    def get(div: int, use_depth: bool):
        if (div, use_depth) not in cache:
            cache[div, use_depth] = _train(tmp, stl, div, use_depth)
        return cache[div, use_depth]

    return get


def assert_cases_equal(t_cases, j_cases):
    assert len(t_cases) == len(j_cases)
    for a, b in zip(t_cases, j_cases):
        assert {f: getattr(a, f) for f in FIELDS} == {f: getattr(b, f) for f in FIELDS}


@pytest.mark.parametrize("use_depth", [False, True], ids=["rgb", "rgbd"])
def test_evaluate_match_px_equals_reference(trained, use_depth):
    tr = trained(4, use_depth)
    meta = tr["tparams"][0]
    ids = list(range(tr["bank"].num_templates))
    t = TEV.evaluate_match_px(tr["tdet"], tr["trend"], meta, ids, 85.0, use_depth=use_depth)
    j = JEV.evaluate_match_px(tr["jdet"], tr["jrend"], tr["jparams"][0], ids, 85.0,
                              use_depth=use_depth)
    assert_cases_equal(t, j)
    # both packages' detectors read back from the bank file: the same cases
    assert_cases_equal(
        TEV.evaluate_match_px(tr["tdet_file"], tr["trend"], meta, ids[:2], 85.0,
                              use_depth=use_depth),
        JEV.evaluate_match_px(tr["jdet_file"], tr["jrend"], tr["jparams"][0], ids[:2], 85.0,
                              use_depth=use_depth))
    s = TEV.summarize(t, [])
    assert s["match"]["found_rate"] == 1.0
    assert s["match"]["px_err"]["max"] <= 2.9, s["match"]
    assert s["match"]["score"]["p50"] >= 99.0
    assert s == JEV.summarize(j, [])


def test_evaluate_pose_equals_reference(trained, tmp_path):
    tr = trained(4, False)
    (tmeta, tglob), (jmeta, jglob) = tr["tparams"], tr["jparams"]
    mesh = cuboid_mesh()
    WH = (tr["W"], tr["H"])
    tpipe = TPipe(tr["tdet"], tmeta, tglob, mesh, TC.CascadeParams(**CASCADE), render_size=WH)
    jpipe = JPipe(tr["jdet"], jmeta, jglob, mesh, JC.CascadeParams(**CASCADE), render_size=WH)
    ids = [0, 1, 2]
    t = TEV.evaluate_pose(tpipe, tr["trend"], tmeta, ids, 85.0)
    j = JEV.evaluate_pose(jpipe, tr["jrend"], jmeta, ids, 85.0)
    assert [c.found for c in t] == [c.found for c in j]
    assert sum(c.found for c in t) >= 2
    for a, b in zip(t, j):
        assert a.view_id == b.view_id
        if a.found:
            assert abs(a.deg_err - b.deg_err) <= DEG_TOL, (a, b)
            assert abs(a.cm_err - b.cm_err) <= CM_TOL, (a, b)
            assert abs(a.score - b.score) <= 1e-4, (a, b)
    # the reference test's pose bars
    s = TEV.summarize([], t)
    assert s["pose"]["deg_err"]["p50"] <= 5.0 and s["pose"]["cm_err"]["p50"] <= 1.0, s
    p = tmp_path / "accuracy.json"
    TEV.write_report(str(p), s)
    with open(p) as f:
        assert json.load(f) == json.loads(json.dumps(s))


@pytest.mark.parametrize("with_depth", [False, True], ids=["rgb", "depth"])
def test_make_ab_scenes_equal_for_a_seed(trained, with_depth):
    tr = trained(4, False)
    kw = dict(n_shifted=3, n_cluttered=2, n_multi=2, n_occluded=2, n_negative=1,
              with_depth=with_depth)
    ids = [0, 2, 3]
    t = TEV.make_ab_scenes(tr["trend"], tr["tparams"][0], ids, tr["W"], tr["H"],
                           np.random.default_rng(11), **kw)
    j = JEV.make_ab_scenes(tr["jrend"], tr["jparams"][0], ids, tr["W"], tr["H"],
                           np.random.default_rng(11), **kw)
    assert len(t) == len(j) == 10
    assert [s[-1] for s in t] == ["shifted"] * 3 + ["cluttered"] * 2 + ["multi"] * 2 + [
        "occluded"] * 2 + ["negative"]
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a[0], b[0])
        assert a[-2] == b[-2] and a[-1] == b[-1]
        if with_depth:
            assert a[1].dtype == np.float32
            np.testing.assert_allclose(a[1], b[1], rtol=0, atol=1e-3)


def test_summarize_empty_and_found_rates():
    cases = [TEV.EvalCase(view_id=0, found=False),
             TEV.EvalCase(view_id=1, found=True, px_err=1.0, px_err_tie=0.0, score=100.0)]
    jcases = [JEV.EvalCase(**c.__dict__) for c in cases]
    assert TEV.summarize(cases, cases) == JEV.summarize(jcases, jcases)
    assert TEV.summarize([], []) == JEV.summarize([], [])
    assert TEV.summarize(cases, [])["match"]["found_rate"] == 0.5


needs_oracle = pytest.mark.skipif(not TORC.available(),
                                  reason="cv::linemod oracle cannot build here")


@needs_oracle
@pytest.mark.parametrize("use_depth", [False, True], ids=["rgb", "rgbd"])
def test_evaluate_vs_opencv_equals_reference(trained, use_depth):
    tr = trained(2, use_depth)
    ids = [0, 1, 2]
    t = TEV.evaluate_vs_opencv(tr["tdet"], tr["trend"], tr["tparams"][0], ids, 85.0,
                               use_depth=use_depth)
    j = JEV.evaluate_vs_opencv(tr["jdet"], tr["jrend"], tr["jparams"][0], ids, 85.0,
                               use_depth=use_depth)
    assert t["available"] and t == j
    assert t["hit_miss_agreement"] == 1.0 and t["px_delta"]["max"] == 0.0, t


@needs_oracle
def test_evaluate_bank_ab_equals_reference(trained):
    tr = trained(2, True)
    kw = dict(n_shifted=2, n_cluttered=2, n_multi=1, n_occluded=1, n_negative=1,
              with_depth=True)
    ids = [0, 1]
    t_sc = TEV.make_ab_scenes(tr["trend"], tr["tparams"][0], ids, tr["W"], tr["H"],
                              np.random.default_rng(5), **kw)
    j_sc = JEV.make_ab_scenes(tr["jrend"], tr["jparams"][0], ids, tr["W"], tr["H"],
                              np.random.default_rng(5), **kw)
    for a, b in zip(t_sc, j_sc):
        np.testing.assert_array_equal(a[0], b[0])
        assert a[2] == b[2]
    # both harnesses on the same scenes (the port's, whose depth is the
    # port's render)
    t = TEV.evaluate_bank_ab(tr["tdet"], t_sc, threshold=85.0)
    assert t["available"] and t["n_scenes"] == 7 and t["n_objects"] == 7
    assert t == JEV.evaluate_bank_ab(tr["jdet"], t_sc, threshold=85.0)
    # the colour-only scenes on the RGB-only bank
    rgb = trained(2, False)
    rgb_only = [(s[0], s[2], s[3]) for s in t_sc]
    assert TEV.evaluate_bank_ab(rgb["tdet"], rgb_only, 85.0) == JEV.evaluate_bank_ab(
        rgb["jdet"], rgb_only, 85.0)


def test_harness_answers_unavailable_without_the_oracle(trained, monkeypatch):
    tr = trained(4, False)
    monkeypatch.setattr(TORC, "available", lambda: False)
    assert TEV.evaluate_vs_opencv(tr["tdet"], tr["trend"], tr["tparams"][0], [0]) == {
        "available": False}
    assert TEV.evaluate_bank_ab(tr["tdet"], []) == {"available": False}
