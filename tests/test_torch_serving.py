"""PyTorch port vs the JAX reference, on CPU: the serving helpers of
models/serving.py (look_at_point, template_refinement) and what only they
reach — utils/pointcloud.py's extract_rect_points and cloud_to_depth_mm,
models/cascade.py's _transplanted_scene_mask.

Tolerances: extract_rect_points, cloud_to_depth_mm, the transplanted
masks and look_at_point are exact (copied values, integers, booleans).
template_refinement at 160x120 on the cuboid (the 160x120 fixture of
tests/test_torch_cascade.py): the refined pose within REFINE_TOL
(elementwise) and the ICP fitness within FITNESS_TOL of the reference's
from the same input pose — the render, the clouds and ICP are float
geometry that the reference's CPU XLA contracts into FMAs (measured:
5.4e-7 on the transform, 3.5e-11 on the fitness).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _xdist_threads  # noqa: F401  (PyTorch threads per xdist worker)

from linemod_pose_estimation_tpu.models import cascade as JC
from linemod_pose_estimation_tpu.models import serving as JS
from linemod_pose_estimation_tpu.utils import pointcloud as JP
from linemod_pose_estimation_tpu_torch.models import cascade as TC
from linemod_pose_estimation_tpu_torch.models import serving as TS
from linemod_pose_estimation_tpu_torch.utils import pointcloud as TP
from test_torch_cascade import meta, pipelines  # noqa: F401  (the 160x120 fixture)

REFINE_TOL, FITNESS_TOL = 1e-4, 1e-6
t = lambda a: torch.from_numpy(np.array(a))


def _cloud(seed, H=30, W=40, holes=0.2):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(H, W, 3)).astype(np.float32)
    c[..., 2] += 1.0
    nan = rng.random((H, W)) < holes
    c[nan, rng.integers(0, 3, int(nan.sum()))] = np.nan
    return c


@pytest.mark.parametrize("rect, cap, with_mask, bias_x", [
    ((5, 4, 20, 15), 1024, False, 0),   # cap above the whole frame: every row
    ((5, 4, 20, 15), 64, False, 0),     # cap below the selected count
    ((5, 4, 20, 15), 300, True, 0),
    ((5, 4, 20, 15), 300, True, 3),     # the mask rolls by bias_x
    ((30, 20, 20, 15), 300, True, 7),   # the roll wraps, the rect leaves the frame
    ((-6, -3, 12, 9), 16, False, 2),    # above-left of the frame
])
def test_extract_rect_points(rect, cap, with_mask, bias_x):
    cloud = _cloud(1)
    mask = (np.random.default_rng(2).random(cloud.shape[:2]) < 0.6).astype(np.uint8) * 255
    m = mask if with_mask else None
    jp, jv = JP.extract_rect_points(jnp.asarray(cloud), jnp.asarray(rect), cap,
                                    None if m is None else jnp.asarray(m), bias_x)
    tp, tv = TP.extract_rect_points(t(cloud), rect, cap, None if m is None else t(m), bias_x)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert 0 < int(tv.sum()) or rect[0] < 0


def test_cloud_to_depth_mm():
    cloud = _cloud(3, holes=0.3)
    z = cloud[..., 2]
    z[0, :6] = [65.535, 65.5355, 70.0, np.inf, -np.inf, -0.25]
    z[1, :4] = [1e30, 0.0004999, 0.0015, 12.3456789]
    got = TP.cloud_to_depth_mm(t(cloud))
    want = np.asarray(JP.cloud_to_depth_mm(jnp.asarray(cloud)))
    assert got.dtype == torch.uint16 and want.dtype == np.uint16
    np.testing.assert_array_equal(got.numpy(), want)


def _silhouette(mh=24, mw=30, seed=4):
    """A blob inside its bbox `rect` in an (mh, mw) render, zero outside."""
    rng = np.random.default_rng(seed)
    m = np.zeros((mh, mw), np.uint8)
    rect = np.array([6, 5, 17, 12], np.int32)
    m[5:17, 6:23] = (rng.random((12, 17)) < 0.8) * 255
    m[5, 6] = m[16, 22] = 255  # the bbox is tight
    return m, rect


@pytest.mark.parametrize("X, Y", [
    (10, 8), (0, 0), (-5, -4), (-16, 3), (-40, -40), (55, 12), (58, 40), (70, 90),
    (12, 40), (20, -11), (-100, 200), (300, -300)])
def test_transplanted_scene_mask_exact(X, Y):
    """Placements inside, across and past every edge of a 45 x 60 scene;
    the far ones are where the canvas slice's start is clamped."""
    m, rect = _silhouette()
    H, W = 45, 60
    want = JC._transplanted_scene_mask(jnp.asarray(m), jnp.asarray(rect), jnp.asarray(X),
                                       jnp.asarray(Y), H, W)
    got = TC._transplanted_scene_mask(t(m), t(rect), X, Y, H, W)
    assert got.shape == (H, W) and got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_look_at_point_center_and_fallback():
    """The two cases of tests/test_serving.py, plus a rect off the frame
    whose clipped centre is NaN; each equal to the reference's point."""
    cloud = np.full((40, 60, 3), np.nan, np.float32)
    cloud[10:30, 20:50] = [0.1, 0.2, 0.6]
    cloud2 = np.full((40, 60, 3), np.nan, np.float32)
    cloud2[10:12, 20:22] = [0.3, 0.1, 0.5]
    cloud3 = _cloud(5, 40, 60, holes=0.5)
    cloud3[39, 59] = np.nan
    for c, rect, expect in ((cloud, (20, 10, 30, 20), [0.1, 0.2, 0.6]),
                            (cloud2, (18, 8, 10, 10), [0.3, 0.1, 0.5]),
                            (cloud3, (50, 35, 30, 20), None),
                            (cloud3, (3, 2, 25, 17), None)):
        want = np.asarray(JS.look_at_point(jnp.asarray(c), rect))
        got = TS.look_at_point(t(c), rect).numpy()
        np.testing.assert_array_equal(got, want)
        if expect is not None:
            np.testing.assert_allclose(got, expect, atol=1e-6)


@pytest.mark.parametrize("viewport", [64, 0])
def test_template_refinement_matches_reference(pipelines, viewport):  # noqa: F811
    """From the reference detection's pose and rect on the fixture scene,
    with the viewport on (64 < 120) and off; the caller's K_render is not
    written to."""
    jpipe, tpipe, jmeta, rgb, cloud = pipelines
    det = jpipe.detect(rgb, cloud, threshold=85.0)[0]
    K_before = tpipe.K_render.clone()
    kw = dict(model_cap=512, scene_cap=512, viewport=viewport)
    jT, jfit = JS.template_refinement(jnp.asarray(det.pose), jnp.asarray(cloud), det.rect,
                                      jpipe.triangles, jpipe.K_render, jpipe.render_wh, **kw)
    tT, tfit = TS.template_refinement(t(det.pose), t(cloud), det.rect, tpipe.triangles,
                                      tpipe.K_render, tpipe.render_wh, **kw)
    assert torch.equal(tpipe.K_render, K_before)
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), atol=REFINE_TOL)
    assert abs(float(tfit) - float(jfit)) <= FITNESS_TOL
    R = tT.numpy()[:3, :3].astype(np.float64)
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
