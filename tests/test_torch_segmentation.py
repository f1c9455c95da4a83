"""PyTorch port vs the JAX reference: the cloud segmentation ops
(ops/segmentation.py: mls_smooth, _propagate_min_labels,
region_growing_largest, euclidean_cluster_largest) and the grasp planner
(models/grasp.py: grasping_pose_region_growing), on CPU.

Inputs: the seeded clouds of tests/test_segmentation.py (its five cases,
each through both packages), a cloud with an isolated point, a cloud too
small for any region, an exact plane facing the camera, and the real
clouds of tests/data/torch_aux_golden.npz (the sweep views' scene clouds
and a 4096-point ROI of a cascade golden frame; tools/
make_torch_aux_golden.py).

Tolerances: masks and labels equal, and no threshold flip was seen in
any case here (a flip fails the test, which names the points).  Smoothed
points within 1e-6 m (measured: at most 2.4e-7); normals and curvature
of the same smoothed points within 1e-5 and 1e-6 (measured 6e-7 and
4e-7; normals recomputed from the port's own smoothing move further,
3.4e-4 on view45's and one flipped on the ROI's, where an ulp in a point
reorders a 50th neighbour, so normals are compared from the same input); grasp poses within 1e-4
degrees and 1e-6 m on the seeded clouds, 1e-3 degrees and 1e-6 m on the
real ones (measured: 5.6e-5 and 3.7e-5 degrees on the sweep views,
2.7e-4 on the 4096-point ROI, whose surface normal carries its MLS
points' ulps; at most 1.9e-7 m).  A point with fewer than 3 MLS
neighbours has a plane the solver picks (a repeated smallest eigenvalue):
such points are counted and held to an invariant, not to the
reference's vector.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _xdist_threads  # noqa: F401  (PyTorch threads per xdist worker)

from linemod_pose_estimation_tpu.models.grasp import grasping_pose_region_growing as JG
from linemod_pose_estimation_tpu.ops import segmentation as JS
from linemod_pose_estimation_tpu_torch.models.grasp import grasping_pose_region_growing as TG
from linemod_pose_estimation_tpu_torch.ops import segmentation as TS
from linemod_pose_estimation_tpu_torch.utils.geometry import rotation_geodesic_deg

from test_segmentation import two_planes

AUX_GOLDEN = "tests/data/torch_aux_golden.npz"
MLS_RADIUS = 0.04
t = lambda a: torch.from_numpy(np.array(a))
j = jnp.asarray


def assert_mask_equal(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    flips = np.nonzero(got != want)[0]
    assert flips.size == 0, f"{what}: {flips.size} points flipped: {flips[:20].tolist()}"


def pose_err(a, b):
    """(degrees, metres) between two (4, 4) poses."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    deg = float(rotation_geodesic_deg(torch.tensor(a[:3, :3]), torch.tensor(b[:3, :3])))
    return deg, float(np.linalg.norm(a[:3, 3] - b[:3, 3]))


def support(points, valid, k=32, radius=MLS_RADIUS):
    """Each point's neighbours within the MLS radius (the reference's kNN)."""
    idx, ok = JS.knn_indices(j(points), j(valid), k)
    d2 = np.sum((points[np.asarray(idx)] - points[:, None, :]) ** 2, axis=-1)
    return (np.asarray(ok) & (d2 < np.float32(radius * radius))).sum(1)


def check_grasp(p, v, pose_tol=(1e-4, 1e-6), **kw):
    jpose, jreg = JG(j(p), j(v), **kw)
    tpose, treg = TG(t(p), t(v), **kw)
    assert_mask_equal(treg.numpy(), jreg, "grasp region")
    deg, m = pose_err(tpose.numpy(), jpose)
    assert deg <= pose_tol[0] and m <= pose_tol[1], (deg, m)
    return tpose.numpy(), treg.numpy()


# -- the reference's five cases, through both packages -------------------------


def test_estimate_normals_flat_plane(rng):
    a, _ = two_planes(rng)
    valid = np.ones(len(a), bool)
    jn, jc = JS.estimate_normals(j(a), j(valid), k=20)
    tn, tc = TS.estimate_normals(t(a), t(valid), k=20)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    nz = tn.numpy()[:, 2]
    assert np.mean(np.abs(nz) > 0.99) > 0.95 and np.mean(nz < 0) > 0.9


@pytest.mark.parametrize("tol", [0.05, 0.01, 0.002])
def test_euclidean_cluster_largest(rng, tol):
    """tol 0.05 splits the two planes (the reference's case); 0.01 and
    0.002 cut the big plane into pieces, the smallest below min_cluster."""
    a, b = two_planes(rng)
    pts = np.concatenate([a, b])
    valid = np.ones(len(pts), bool)
    valid[7] = False
    want = JS.euclidean_cluster_largest(j(pts), j(valid), tolerance=tol)
    got = TS.euclidean_cluster_largest(t(pts), t(valid), tolerance=tol)
    assert_mask_equal(got, want, f"euclid {tol}")
    if tol == 0.05:
        assert got[: len(a)].sum() == len(a) - 1 and not got[len(a):].any()


def _corner(rng, n=200):
    a = np.zeros((n, 3), np.float32)
    a[:, 0] = rng.uniform(0, 0.1, n)
    a[:, 1] = rng.uniform(0, 0.1, n)
    a[:, 2] = 0.5
    b = np.zeros((n // 2, 3), np.float32)
    b[:, 0] = 0.1
    b[:, 1] = rng.uniform(0, 0.1, n // 2)
    b[:, 2] = 0.5 + rng.uniform(0.003, 0.1, n // 2)
    return np.concatenate([a, b]), n


@pytest.mark.parametrize("deg,curv,k", [(10.0, 0.05, 10), (5.0, 1.0, 30), (30.0, 0.01, 15)])
def test_region_growing_splits_by_normal(rng, deg, curv, k):
    """A horizontal and a vertical plane meeting at an edge: the
    reference's case (10 degrees, curvature 0.05, k 10), then other
    thresholds.  Both packages get the same normals (the reference's)."""
    pts, n = _corner(rng)
    valid = np.ones(len(pts), bool)
    normals, curv_ = JS.estimate_normals(j(pts), j(valid), k=15)
    want = JS.region_growing_largest(j(pts), j(valid), normals, curv_, deg, curv, k=k)
    got = TS.region_growing_largest(t(pts), t(valid), t(normals), t(curv_), deg, curv, k=k)
    assert_mask_equal(got, want, "region")
    if deg == 10.0:
        assert got[:n].float().mean() > 0.8 and got[n:].float().mean() < 0.2


def test_region_growing_smoothness_threshold_is_f32():
    """cos(radians(deg)) in f32 as the reference's traced f32: equal at the
    degrees the tests and the grasp planner use."""
    for deg in (5.0, 8.0, 10.0, 30.0, 45.0, 89.5):
        want = float(jnp.cos(jnp.radians(jnp.float32(deg))))
        got = float(torch.cos(torch.tensor(deg) * torch.tensor(np.pi / 180, dtype=torch.float32)))
        assert got == want, deg


def test_mls_smooth_reduces_noise(rng):
    a, _ = two_planes(rng, n_each=300)
    noisy = a + rng.normal(scale=0.002, size=a.shape).astype(np.float32) * np.array(
        [0, 0, 1], np.float32)
    valid = np.ones(len(a), bool)
    want = np.asarray(JS.mls_smooth(j(noisy), j(valid), radius=0.05))
    got = TS.mls_smooth(t(noisy), t(valid), radius=0.05).numpy()
    assert (support(noisy, valid, radius=0.05) >= 3).all()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert np.std(got[:, 2]) < np.std(noisy[:, 2]) * 0.7


def test_grasp_pose_on_flat_surface(rng):
    a, _ = two_planes(rng, n_each=300)
    valid = np.ones(len(a), bool)
    pose, region = check_grasp(a, valid, normal_thresh_deg=8.0, curvature_thresh=0.1,
                               offset=0.05)
    assert region.sum() > 200
    np.testing.assert_allclose(pose[2, 3], 0.55, atol=0.02)
    np.testing.assert_allclose(np.abs(pose[2, 2]), 1.0, atol=0.05)
    np.testing.assert_allclose(pose[:3, :3] @ pose[:3, :3].T, np.eye(3), atol=1e-5)


# -- edge cases ---------------------------------------------------------------


def test_mls_isolated_point_is_projected_as_the_reference_does(rng):
    """A point with no neighbour inside the radius has a zero covariance and
    mean; LAPACK's identity eigenvectors put it on the plane x = 0 through
    the origin: (1, 1, 1) -> (0, 1, 1) in both packages (a fault of the
    reference, ported as it is).  Points with 1-2 neighbours (a repeated
    smallest eigenvalue) are counted and held to the invariant that the
    projection moves a point no farther than its neighbours' mean."""
    a, _ = two_planes(rng, n_each=300)
    pts = np.concatenate([a, [[1.0, 1.0, 1.0], [0.9, 0.9, 0.9], [0.91, 0.9, 0.9]]]
                         ).astype(np.float32)
    valid = np.ones(len(pts), bool)
    want = np.asarray(JS.mls_smooth(j(pts), j(valid)))
    got = TS.mls_smooth(t(pts), t(valid)).numpy()
    sup = support(pts, valid)
    assert sup.tolist()[-3:] == [0, 1, 1] and (sup[:-3] >= 3).all()
    np.testing.assert_array_equal(got[300], [0.0, 1.0, 1.0])
    np.testing.assert_array_equal(want[300], [0.0, 1.0, 1.0])
    full = sup >= 3
    np.testing.assert_allclose(got[full], want[full], atol=1e-6)
    for i in np.nonzero((sup > 0) & (sup < 3))[0]:
        mean = pts[603 - i]  # 301 and 302 are each other's one neighbour
        assert np.linalg.norm(got[i] - pts[i]) <= np.linalg.norm(pts[i] - mean) + 1e-6


def test_grasp_empty_region_takes_point_zero(rng):
    """Fewer valid points than min_cluster: no region, every distance inf,
    and the surface point is point 0 in both packages."""
    a, _ = two_planes(rng, n_each=300)
    valid = np.arange(len(a)) < 40
    pose, region = check_grasp(a, valid)
    assert not region.any()


def test_grasp_normal_along_z_takes_the_fallback_axis():
    """An exact plane behind the camera (z = -0.5): its normal, oriented
    toward the origin, is (0, 0, 1); z x n is zero, so the axis falls back
    to x, and the rotation by -pi about it is diag(1, -1, -1)."""
    g = np.stack(np.meshgrid(np.arange(20), np.arange(20)), -1).reshape(-1, 2) * 0.005
    pts = np.concatenate([g, np.full((400, 1), -0.5)], 1).astype(np.float32)
    pose, region = check_grasp(pts, np.ones(400, bool))
    assert region.all()
    np.testing.assert_allclose(pose[:3, :3], np.diag([1.0, -1.0, -1.0]), atol=1e-6)


def test_propagate_min_labels():
    """Random directed graphs: to the fixed point (64 steps) and cut short
    (3 steps, not converged), equal to the reference's while loop."""
    rng = np.random.default_rng(3)
    n, k = 300, 6
    idx = rng.integers(0, n, (n, k)).astype(np.int32)
    ok = rng.random((n, k)) < 0.3
    lab0 = np.where(rng.random(n) < 0.9, np.arange(n), 2**30).astype(np.int32)
    for it in (64, 3):
        want = np.asarray(JS._propagate_min_labels(j(lab0), j(idx), j(ok), it))
        got = TS._propagate_min_labels(t(lab0), t(idx).long(), t(ok), it).numpy()
        np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) > 1


# -- the real clouds against the golden -----------------------------------------


@pytest.fixture(scope="module")
def golden():
    with np.load(AUX_GOLDEN) as z:
        g = {k: z[k] for k in z.files}
    clouds = {"roi": (g["roi_pts"], g["roi_valid"])}
    for name in ("view00", "view45"):
        with np.load(f"data/sweep_{name}_clouds.npz") as z:
            clouds[name] = (z["scene"], z["svalid"])
    return g, clouds


@pytest.mark.parametrize("name", ["view00", "view45", "roi"])
def test_real_clouds_against_golden(golden, name):
    """MLS, normals, region, euclidean mask and grasp pose on the real
    clouds.  No point of them has fewer than 3 MLS neighbours."""
    g, clouds = golden
    p, v = clouds[name]
    assert (g[f"{name}_support"][v] >= 3).all()
    sm = TS.mls_smooth(t(p), t(v))
    np.testing.assert_allclose(sm.numpy(), g[f"{name}_mls"], atol=1e-6)
    n, c = TS.estimate_normals(t(g[f"{name}_mls"]), t(v), k=50)
    np.testing.assert_allclose(n.numpy(), g[f"{name}_normals"], atol=1e-5)
    np.testing.assert_allclose(c.numpy(), g[f"{name}_curvature"], atol=1e-6)
    assert_mask_equal(TS.euclidean_cluster_largest(t(p), t(v), 0.005), g[f"{name}_euclid"],
                      "euclid")
    pose, region = TG(t(p), t(v))
    assert_mask_equal(region, g[f"{name}_region"], "region")
    deg, m = pose_err(pose.numpy(), g[f"{name}_pose"])
    assert deg <= 1e-3 and m <= 1e-6, (deg, m)
    assert 0 < int(g[f"{name}_euclid"].sum()) <= int(v.sum())
