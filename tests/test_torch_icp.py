"""PyTorch port vs the JAX reference: point-to-point ICP (ops/icp.py) on
the committed real clouds ``data/sweep_view{00,45}_clouds.npz`` and on
seeded synthetic clouds, on CPU.

Tolerances: transforms within 1e-4 (about 0.006 degrees and 0.1 mm; the
reference's CPU XLA sums and fuses in its own order, so nearest-
neighbour distances differ by f32 ulps); the convergence flags and the
per-lane iteration counts are equal; the inlier counts within 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _xdist_threads  # noqa: F401  (PyTorch threads per xdist worker)

from linemod_pose_estimation_tpu.ops import icp as JI
from linemod_pose_estimation_tpu_torch.ops import icp as TI

TOL = 1e-4
t = lambda a: torch.from_numpy(np.array(a))


def _rot(rng, max_deg):
    th = np.deg2rad(rng.uniform(-max_deg, max_deg))
    ax = rng.normal(size=3)
    ax /= np.linalg.norm(ax)
    K = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]], [-ax[1], ax[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _perturb(pts, valid, rng, max_deg=4.0, max_shift=0.004):
    c = pts[valid].mean(0)
    out = (pts - c) @ _rot(rng, max_deg).T + c + rng.uniform(-max_shift, max_shift, 3)
    return np.where(valid[:, None], out, pts).astype(np.float32)


def _box_surface(rng, n, dims=(0.088, 0.144, 0.076), z=0.7):
    """Points on three visible faces of a box ~z m from the camera."""
    face = rng.integers(0, 3, n)
    p = rng.uniform(-0.5, 0.5, size=(n, 3)) * dims
    for ax in range(3):
        p[face == ax, ax] = -dims[ax] / 2
    return (p + [0.0, 0.0, z]).astype(np.float32)


def _assert_same(got, want):
    np.testing.assert_allclose(got.transform.numpy(), np.asarray(want.transform), atol=TOL)
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(want.iterations))
    assert np.abs(got.num_inliers.numpy() - np.asarray(want.num_inliers)).max() <= 2


@pytest.mark.parametrize("stem", ["sweep_view00_clouds", "sweep_view45_clouds"])
@pytest.mark.parametrize("seed", range(3))
def test_icp_two_stage_real_clouds(stem, seed):
    z = np.load(f"data/{stem}.npz")
    model = _perturb(z["model"], z["mvalid"], np.random.default_rng(seed))
    args = (model, z["mvalid"], z["scene"].astype(np.float32), z["svalid"])
    want = JI.icp_two_stage(*(jnp.asarray(a) for a in args))
    got = TI.icp_two_stage(*(t(a) for a in args))
    _assert_same(got, want)
    assert bool(got.converged)


def test_icp_lanes_stop_where_the_reference_does():
    """Four lanes in one batch — small, large and no perturbation, and a
    lane with no valid model points — against the reference's vmapped
    while_loop: each lane's transform, iteration count and flags."""
    rng = np.random.default_rng(5)
    scene = _box_surface(rng, 600)
    svalid = np.arange(600) < 560
    models, mvalids = [], []
    for deg, shift, n_valid in ((1.0, 0.001, 500), (6.0, 0.008, 500), (0.0, 0.0, 500),
                                (3.0, 0.002, 0)):
        m = _box_surface(rng, 600)
        mv = np.arange(600) < n_valid
        if n_valid:
            m = _perturb(m, mv, rng, deg, shift)
        models.append(m)
        mvalids.append(mv)
    args = (np.stack(models), np.stack(mvalids), np.stack([scene] * 4),
            np.stack([svalid] * 4))
    kw = dict(max_iterations=50, max_corr_dist=0.05, rejection_dist=0.02,
              transform_epsilon=1e-5)
    want = jax.vmap(lambda m, mv, s, sv: JI.icp(m, mv, s, sv, **kw))(
        *(jnp.asarray(a) for a in args))
    got = TI.icp(*(t(a) for a in args), **kw)
    _assert_same(got, want)
    assert len(set(got.iterations.tolist())) > 1  # lanes stopped at different steps
    assert torch.equal(got.transform[3], torch.eye(4))  # the empty lane: identity


@pytest.mark.parametrize("seed", range(3))
def test_kabsch(seed):
    """Weighted Kabsch against the reference, including a mirrored target
    (the reflection fix keeps det(R) = +1)."""
    rng = np.random.default_rng(40 + seed)
    src = rng.normal(size=(64, 3)).astype(np.float32)
    dst = (src @ _rot(rng, 40).T + rng.normal(size=3)).astype(np.float32)
    if seed == 2:
        dst[:, 0] *= -1
    w = (rng.random(64) < 0.8).astype(np.float32)
    got = TI._kabsch(t(src), t(dst), t(w)).numpy()
    want = np.asarray(JI._kabsch(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert abs(np.linalg.det(got[:3, :3]) - 1.0) < 1e-5
