"""The port's view sphere (``utils/viewsphere.py``, its own copy) and
``utils/geometry.py::look_at_object`` against the JAX package's.

Tolerances: the views are equal element for element (the same float64
formulas in the same order), in the same radius-angle-point order,
including the degenerate-up branches; look_at_object (f32) within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linemod_pose_estimation_tpu.utils import geometry as JG
from linemod_pose_estimation_tpu.utils import viewsphere as JV
from linemod_pose_estimation_tpu_torch.utils import geometry as TG
from linemod_pose_estimation_tpu_torch.utils import viewsphere as TV

SPHERES = {
    "default": {},  # the launch-scale sphere: 150 points x 36 angles x 6 radii
    "small": dict(n_points=4, angle_step=180, radius_min=0.5, radius_max=0.5),
    "radii_3": dict(n_points=10, angle_step=90, radius_min=0.5, radius_max=0.7),
    "full_sphere": dict(n_points=17, angle_step=45, restricted=False),
    # points within 0.0005 of the pole: the other base vector (|fwd z| > 0.999)
    "pole": dict(n_points=3, angle_step=120, min_elevation=0.9995),
    "angle_window": dict(n_points=6, angle_step=7, angle_min=20.0, angle_max=95.0,
                         radius_min=0.55, radius_max=0.8, radius_step=0.05),
}


@pytest.mark.parametrize("name", list(SPHERES))
def test_views_equal_element_for_element(name):
    kw = SPHERES[name]
    jv = JV.generate_views(JV.ViewSphereParams(**kw))
    tv = TV.generate_views(TV.ViewSphereParams(**kw))
    assert len(tv) == len(jv) > 0
    for a, b in zip(jv, tv):
        for f in ("R", "T", "up"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
            assert getattr(b, f).dtype == np.float64
        assert a.D_obj == b.D_obj
    if name == "default":
        assert len(tv) == 150 * 36 * 6
        assert [v.D_obj for v in tv[::5400]] == [jv[i].D_obj for i in range(0, 32400, 5400)]


@pytest.mark.parametrize("hemisphere,min_z,n", [(True, 0.1, 150), (False, 0.0, 33),
                                                (True, 0.9995, 3)])
def test_fibonacci_sphere_equal(hemisphere, min_z, n):
    assert np.array_equal(JV.fibonacci_sphere(n, hemisphere, min_z),
                          TV.fibonacci_sphere(n, hemisphere, min_z))


@pytest.mark.parametrize("case", ["regular", "up_along_axis", "up_along_axis_x"])
def test_look_at_np_equal_with_its_degenerate_branch(case):
    rng = np.random.default_rng(7)
    for _ in range(20):
        eye = rng.normal(size=3)
        if case == "regular":
            up = rng.normal(size=3)
        elif case == "up_along_axis":  # up || view axis: another up is taken
            up = eye * rng.uniform(0.5, 2.0)
        else:  # view axis near x: the y axis is taken as up
            eye = np.array([rng.uniform(1, 2), 0.01 * rng.normal(), 0.01 * rng.normal()])
            up = -eye
        a, b = JV._look_at_np(eye, up), TV._look_at_np(eye, up)
        assert np.array_equal(a, b)
        np.testing.assert_allclose(b @ b.T, np.eye(3), atol=1e-12)


@pytest.mark.parametrize("seed", range(4))
def test_look_at_object_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(16):
        eye = (rng.normal(size=3) * rng.uniform(0.3, 1.5)).astype(np.float32)
        up = rng.normal(size=3).astype(np.float32)
        j = np.asarray(JG.look_at_object(jnp.asarray(eye), jnp.asarray(up)))
        t = TG.look_at_object(torch.from_numpy(eye), torch.from_numpy(up)).numpy()
        np.testing.assert_allclose(t, j, atol=1e-6)
        # row 2 is the forward axis, normalize(-eye)
        np.testing.assert_allclose(t[2], -eye / np.linalg.norm(eye), atol=1e-6)


def test_look_at_object_gives_the_views_rotations():
    """Each view's rotation is look_at_object of its own eye (-T) and up
    (in float64: within rounding)."""
    for v in TV.generate_views(TV.ViewSphereParams(**SPHERES["radii_3"])):
        R = TG.look_at_object(torch.tensor(-v.T, dtype=torch.float64),
                              torch.tensor(v.up, dtype=torch.float64)).numpy()
        np.testing.assert_allclose(R, v.R, atol=1e-12)
