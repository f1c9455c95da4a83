"""PyTorch port vs the JAX reference: surface normals from depth and the
depth / normal re-scoring of a match (ops/verification.py), on CPU.

Inputs: a seeded synthetic depth image (a tilted plane, a box on it, a
depth step past the 50 mm neighbour gate, holes, a frame edge) and frame 0
of the cascade golden with the bank's intrinsics.

Tolerances: the set of pixels with a normal is equal; unit normals within
2e-6 (the reference's CPU XLA contracts the 2 x 2 solve's products into
FMAs); the score and its two terms within 1e-5 (sums over a 64 x 64
window in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _xdist_threads  # noqa: F401  (PyTorch threads per xdist worker)

from linemod_pose_estimation_tpu.ops import verification as JV
from linemod_pose_estimation_tpu_torch.ops import verification as TV

t = lambda a: torch.from_numpy(np.array(a))
K = np.array([[572.4, 0, 80.0], [0, 573.6, 60.0], [0, 0, 1]], np.float32)


def _depth(seed, H=120, W=160):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    d = 700.0 + 0.8 * xx + 0.3 * yy + rng.normal(scale=0.4, size=(H, W))
    d[30:70, 40:100] = 520.0 + 0.5 * (xx[30:70, 40:100] - 40)  # a box, a step > 50 mm
    d[80:90, 20:60] += 30.0  # a step inside the gate
    d[rng.random((H, W)) < 0.03] = 0.0  # holes
    d[:, :3] = 0.0
    return d.astype(np.float32)


@pytest.mark.parametrize("seed", range(3))
def test_depth_normals(seed):
    d = _depth(seed)
    want = np.asarray(JV.depth_normals(jnp.asarray(d), jnp.asarray(K)))
    got = TV.depth_normals(t(d), t(K)).numpy()
    np.testing.assert_array_equal(np.any(got != 0, -1), np.any(want != 0, -1))
    np.testing.assert_allclose(got, want, atol=2e-6)
    has = np.any(got != 0, -1)
    assert has.mean() > 0.8 and not has[d == 0].any()
    np.testing.assert_allclose(np.linalg.norm(got[has], axis=-1), 1.0, atol=1e-5)
    assert np.all(got[has][:, 2] <= 0)  # towards the camera


def test_depth_normals_golden_frame():
    """640 x 480: the cuboid's faces over a flat background, the frame
    DetectionPipeline.scene_normals sees."""
    with np.load("tests/data/torch_cascade_golden.npz") as z:
        d = z["depth_mm"][0]
    Kf = np.array([[572.4, 0, 320.0], [0, 573.6, 240.0], [0, 0, 1]], np.float32)
    want = np.asarray(JV.depth_normals(jnp.asarray(d), jnp.asarray(Kf)))
    got = TV.depth_normals(t(d), t(Kf)).numpy()
    np.testing.assert_array_equal(np.any(got != 0, -1), np.any(want != 0, -1))
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_depth_normals_integer_depth_and_empty():
    d = _depth(5).astype(np.uint16)
    want = np.asarray(JV.depth_normals(jnp.asarray(d), jnp.asarray(K)))
    np.testing.assert_allclose(TV.depth_normals(t(d.astype(np.int32)), t(K)).numpy(), want,
                               atol=2e-6)
    zero = TV.depth_normals(torch.zeros(8, 9), t(K))
    assert zero.shape == (8, 9, 3) and not bool(zero.any())


@pytest.mark.parametrize("case", ["inside", "clipped", "no_overlap"])
def test_depth_normal_score(case):
    """A template render overlaid at a match position: inside the frame,
    with both windows clipped at the frame's far corner, and where the
    joint mask is empty (score exp(0) * exp(0) = 1)."""
    E = 64
    scene = _depth(1)
    tmpl = np.zeros_like(scene)
    mask = np.zeros(scene.shape, np.uint8)
    tmpl[30:70, 40:100] = scene[30:70, 40:100] + 4.0
    mask[30:70, 40:100] = 255
    rect = np.array([40, 30, 60, 40], np.int32)
    x, y = {"inside": (43, 28), "clipped": (150, 110), "no_overlap": (0, 75)}[case]
    if case == "no_overlap":
        scene = scene.copy()
        scene[:, 0:E] = 0.0  # the scene window (its origin clipped into the frame)
    sn = np.asarray(JV.depth_normals(jnp.asarray(scene), jnp.asarray(K)))
    tn = np.asarray(JV.depth_normals(jnp.asarray(tmpl), jnp.asarray(K)))
    args = (scene, sn, tmpl, mask, tn, rect, np.int32(x), np.int32(y))
    want = JV.depth_normal_score(*(jnp.asarray(a) for a in args), E=E)
    got = TV.depth_normal_score(*(t(a) for a in args), E=E)
    for a, b, name in zip(got, want, ("score", "depth_diff", "normal_diff")):
        np.testing.assert_allclose(float(a), float(b), atol=1e-5, err_msg=name)
    if case == "no_overlap":
        assert float(got[0]) == 1.0
    else:
        assert 0.0 < float(got[0]) < 1.0
    # plain Python ints for the position work too
    again = TV.depth_normal_score(*(t(a) for a in args[:6]), x, y, E=E)
    assert float(again[0]) == float(got[0])
