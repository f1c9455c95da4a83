"""PyTorch port vs the JAX reference: SE(3) / quaternion utilities
(utils/geometry.py) and point-cloud primitives (utils/pointcloud.py), on
seeded numpy inputs, on CPU.

Tolerances: integer and boolean outputs (validity masks, voxel
selections) are equal; f32 values agree within a few ulps of their
magnitude (the reference's CPU XLA fuses products into FMAs and sums in
its own order): 1e-6 for unit quaternions and rotations, 1e-6 m for
points, 2e-9 m^2 for squared distances.

The TF32 test: a TF32 cross term in the pairwise-distance expansion
flips nearest-neighbour assignments and walks ICP off the reference;
the package's import-time pins keep every f32 matmul at full precision.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _xdist_threads  # noqa: F401  (PyTorch threads per xdist worker)

from linemod_pose_estimation_tpu.ops import icp as JI
from linemod_pose_estimation_tpu.utils import geometry as JG
from linemod_pose_estimation_tpu.utils import pointcloud as JP
from linemod_pose_estimation_tpu_torch.ops import icp as TI
from linemod_pose_estimation_tpu_torch.utils import geometry as TG
from linemod_pose_estimation_tpu_torch.utils import pointcloud as TP

t = lambda a: torch.from_numpy(np.array(a))


def _rotations(n, seed=0):
    q = np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.asarray(JG.quat_to_matrix(jnp.asarray(q)))


def _cloud(rng, n, n_valid, center=(0.1, -0.05, 0.8), spread=0.05, outliers=0):
    pts = (np.asarray(center) + rng.normal(scale=spread, size=(n, 3))).astype(np.float32)
    if outliers:
        pts[:outliers] += rng.normal(scale=0.3, size=(outliers, 3)).astype(np.float32)
    valid = np.arange(n) < n_valid
    return np.where(valid[:, None], pts, 1e6).astype(np.float32), valid


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


def test_quaternion_round_trips():
    R = _rotations(64)
    qj = np.asarray(JG.quat_from_matrix(jnp.asarray(R)))
    qt = TG.quat_from_matrix(t(R)).numpy()
    np.testing.assert_allclose(qt, qj, atol=1e-6)
    assert (qt[:, 0] >= 0).all()
    np.testing.assert_allclose(TG.quat_to_matrix(t(qt)).numpy(), R, atol=1e-6)
    np.testing.assert_allclose(TG.quat_to_matrix(t(qj)).numpy(),
                               np.asarray(JG.quat_to_matrix(jnp.asarray(qj))), atol=1e-6)


def test_quaternions_of_the_bank():
    """The pipeline's q_bank: every template rotation of the committed
    params file, in f32, as the reference computes it."""
    from linemod_pose_estimation_tpu_torch.models.templates import TemplateBank

    meta, _ = TemplateBank.read_params_yaml("data/boxNew_rgbd_params.yml.gz")
    R = meta.R.astype(np.float32)
    np.testing.assert_allclose(TG.quat_from_matrix(t(R)).numpy(),
                               np.asarray(JG.quat_from_matrix(jnp.asarray(R))), atol=1e-6)


def test_quat_average_and_geodesic():
    rng = np.random.default_rng(3)
    R = _rotations(8, seed=3)
    q = np.array(JG.quat_from_matrix(jnp.asarray(R)))
    q[::2] *= -1  # mixed hemispheres
    w = rng.uniform(0.5, 2.0, size=8).astype(np.float32)
    np.testing.assert_allclose(TG.quat_average(t(q), t(w)).numpy(),
                               np.asarray(JG.quat_average(jnp.asarray(q), jnp.asarray(w))),
                               atol=1e-6)
    R2 = _rotations(8, seed=4)
    np.testing.assert_allclose(
        TG.rotation_geodesic_deg(t(R), t(R2)).numpy(),
        np.asarray(JG.rotation_geodesic_deg(jnp.asarray(R), jnp.asarray(R2))), atol=1e-3)
    # small angles stay resolved (the atan2 form)
    assert float(TG.rotation_geodesic_deg(t(R[0]), t(R[0]))) < 1e-3


def test_transforms_and_projection():
    rng = np.random.default_rng(5)
    R = _rotations(1, seed=5)[0]
    tv = rng.normal(size=3).astype(np.float32)
    Tj = JG.make_transform(jnp.asarray(R), jnp.asarray(tv))
    Tt = TG.make_transform(t(R), t(tv))
    np.testing.assert_array_equal(Tt.numpy(), np.asarray(Tj))
    np.testing.assert_allclose(TG.invert_transform(Tt).numpy(),
                               np.asarray(JG.invert_transform(Tj)), atol=1e-6)
    pts = (rng.normal(size=(20, 3)) + [0, 0, 2]).astype(np.float32)
    np.testing.assert_allclose(TG.transform_points(Tt, t(pts)).numpy(),
                               np.asarray(JG.transform_points(Tj, jnp.asarray(pts))),
                               atol=1e-6)
    Kj = JG.make_K(535.5, 537.1, 320.0, 240.0)
    Kt = TG.make_K(535.5, 537.1, 320.0, 240.0)
    np.testing.assert_array_equal(Kt.numpy(), np.asarray(Kj))
    np.testing.assert_allclose(TG.project(Kt, t(pts)).numpy(),
                               np.asarray(JG.project(Kj, jnp.asarray(pts))), rtol=1e-6)


# ---------------------------------------------------------------------------
# point clouds
# ---------------------------------------------------------------------------


def test_depth_to_cloud():
    rng = np.random.default_rng(6)
    d = rng.uniform(0.4, 1.6, size=(30, 40)).astype(np.float32)
    d[rng.random(d.shape) < 0.2] = 0.0
    K = np.array([[133.9, 0, 20.0], [0, 134.3, 15.0], [0, 0, 1]], np.float32)
    cj = np.asarray(JP.depth_to_cloud(jnp.asarray(d), jnp.asarray(K)))
    ct = TP.depth_to_cloud(t(d), t(K)).numpy()
    np.testing.assert_array_equal(np.isnan(ct), np.isnan(cj))
    np.testing.assert_allclose(ct, cj, atol=1e-6)


def test_pairwise_sq_dists_m_scale():
    """Millimetre distances between clouds ~0.8 m from the origin (and
    sentinel rows in b): within 2e-9 m^2 (0.2% of a 1 mm distance, the
    f32 expansion's rounding at ~3 cm from the centring point) of a
    float64 truth and of the reference, and the same nearest neighbours."""
    rng = np.random.default_rng(7)
    a, _ = _cloud(rng, 200, 200, spread=0.03)
    b = a + rng.normal(scale=0.002, size=a.shape).astype(np.float32)
    b[150:] = 1e6  # padded slots
    d_t = TP.pairwise_sq_dists(t(a), t(b)).numpy()
    d_j = np.asarray(JP.pairwise_sq_dists(jnp.asarray(a), jnp.asarray(b)))
    truth = ((a[:, None, :].astype(np.float64) - b[None, :150].astype(np.float64)) ** 2).sum(-1)
    np.testing.assert_allclose(d_t[:, :150], truth, atol=2e-9, rtol=1e-5)
    np.testing.assert_allclose(d_t[:, :150], d_j[:, :150], atol=2e-9, rtol=1e-5)
    assert (d_t[:, 150:] > 1e10).all()
    np.testing.assert_array_equal(d_t.argmin(1), d_j.argmin(1))


def test_centroid_and_nearest_point():
    rng = np.random.default_rng(8)
    pts, valid = _cloud(rng, 64, 40)
    q = np.array([0.12, -0.04, 0.79], np.float32)
    np.testing.assert_allclose(
        TP.masked_centroid(t(pts), t(valid)).numpy(),
        np.asarray(JP.masked_centroid(jnp.asarray(pts), jnp.asarray(valid))), atol=1e-6)
    np.testing.assert_array_equal(
        TP.nearest_point(t(pts), t(valid), t(q)).numpy(),
        np.asarray(JP.nearest_point(jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(q))))
    # a batch of lanes gives each lane's answer
    two = TP.nearest_point(t(np.stack([pts, pts[::-1].copy()])),
                           t(np.stack([valid, valid[::-1].copy()])), t(np.stack([q, q])))
    np.testing.assert_array_equal(two[0].numpy(), two[1].numpy())


@pytest.mark.parametrize("seed", range(3))
def test_statistical_outlier_removal(seed):
    rng = np.random.default_rng(20 + seed)
    pts, valid = _cloud(rng, 512, 400, outliers=30)
    got = TP.statistical_outlier_removal(t(pts), t(valid), 50, 1.0).numpy()
    want = np.asarray(JP.statistical_outlier_removal(jnp.asarray(pts), jnp.asarray(valid),
                                                     50, 1.0))
    np.testing.assert_array_equal(got, want)
    assert got.sum() < valid.sum()  # some outliers went


@pytest.mark.parametrize("seed", range(3))
def test_voxel_grid_filter(seed):
    rng = np.random.default_rng(30 + seed)
    pts, valid = _cloud(rng, 512, 450, spread=0.01)
    pj, vj = JP.voxel_grid_filter(jnp.asarray(pts), jnp.asarray(valid), 0.002, 256)
    pt, vt = TP.voxel_grid_filter(t(pts), t(valid), 0.002, 256)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6)
    assert 0 < vt.sum() < valid.sum()


def test_voxel_occupancy_rate():
    rng = np.random.default_rng(9)
    m, mv = _cloud(rng, 300, 250, spread=0.02)
    s, sv = _cloud(rng, 300, 280, spread=0.02)
    s[:100] = m[:100] + 0.0005
    got = float(TP.voxel_occupancy_rate(t(m), t(mv), t(s), t(sv), 0.004))
    want = float(JP.voxel_occupancy_rate(jnp.asarray(m), jnp.asarray(mv), jnp.asarray(s),
                                         jnp.asarray(sv), 0.004))
    assert got == want and 0 < got < 1


# ---------------------------------------------------------------------------
# TF32
# ---------------------------------------------------------------------------


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32's 10-bit mantissa (nearest), as a TF32 tensor
    core reads its operands."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def test_tf32_walks_icp_and_the_pins_keep_it_off(monkeypatch):
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    drift, flips = [], []
    for stem in ("sweep_view00_clouds", "sweep_view45_clouds"):
        z = np.load(f"data/{stem}.npz")
        args = [z["model"], z["mvalid"], z["scene"].astype(np.float32), z["svalid"]]
        ref = JI.icp_two_stage(*(jnp.asarray(a) for a in args))
        full = TI.icp_two_stage(*(t(a) for a in args))
        d_full = TP.pairwise_sq_dists(t(args[0]), t(args[2]))
        with monkeypatch.context() as mp:
            mm = torch.matmul
            mp.setattr(torch, "matmul", lambda a, b: mm(_tf32(a), _tf32(b)))
            tf = TI.icp_two_stage(*(t(a) for a in args))
            d_tf = TP.pairwise_sq_dists(t(args[0]), t(args[2]))
        # Full f32: the reference's transform within the ICP tolerance.
        np.testing.assert_allclose(full.transform.numpy(), np.asarray(ref.transform),
                                   atol=1e-4)
        mv = z["mvalid"]
        flips.append(float((d_full.argmin(1) != d_tf.argmin(1)).numpy()[mv].mean()))
        drift.append(float(np.abs(tf.transform.numpy() - np.asarray(ref.transform)).max()))
    # TF32 flips a few percent of the nearest neighbours and moves the
    # result past the tolerance the f32 path holds.
    assert min(flips) > 0.01, flips
    assert max(drift) > 1e-4, drift
