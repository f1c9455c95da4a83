"""PyTorch port vs the JAX reference: ICP (ops/icp.py) — the Kabsch,
point-to-plane and Levenberg-Marquardt variants and their schedules — on
the committed real clouds ``data/sweep_view{00,45}_clouds.npz`` and on
seeded synthetic clouds, on CPU.

Tolerances: transforms within 1e-4 (about 0.006 degrees and 0.1 mm; the
reference's CPU XLA sums and fuses in its own order, so nearest-
neighbour distances differ by f32 ulps); fitness within 1e-7 m^2; the
convergence flags and the per-lane iteration counts are equal; the
inlier counts within 2.  The single 6 x 6 steps (`_p2plane_delta`,
`_lm_step`) agree within 2e-5 on well-posed inputs; on the face-on
rectangle, where only the alpha = 0.1 point-to-point term holds the
system, within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _xdist_threads  # noqa: F401  (PyTorch threads per xdist worker)

from linemod_pose_estimation_tpu.ops import icp as JI
from linemod_pose_estimation_tpu_torch import convert
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


def _box_with_normals(rng, n, dims=(0.088, 0.144, 0.076), z=0.7):
    """`_box_surface` with each point's face normal (towards the camera
    side the faces sit on)."""
    face = rng.integers(0, 3, n)
    p = rng.uniform(-0.5, 0.5, size=(n, 3)) * dims
    nrm = np.zeros((n, 3), np.float32)
    for ax in range(3):
        p[face == ax, ax] = -dims[ax] / 2
        nrm[face == ax, ax] = -1.0
    return (p + [0.0, 0.0, z]).astype(np.float32), nrm


def _lanes(rng, n=600, spec=((1.0, 0.001, 500), (6.0, 0.008, 500), (0.0, 0.0, 500),
                              (3.0, 0.002, 0))):
    """Model lanes (rotation deg, shift m, valid count) against one box
    scene with normals: (models, mvalids, scenes, normals, svalids)."""
    scene, nrm = _box_with_normals(rng, n)
    svalid = np.arange(n) < n - 40
    models, mvalids = [], []
    for deg, shift, n_valid in spec:
        m = _box_surface(rng, n)
        mv = np.arange(n) < n_valid
        if n_valid:
            m = _perturb(m, mv, rng, deg, shift)
        models.append(m)
        mvalids.append(mv)
    L = len(spec)
    return (np.stack(models), np.stack(mvalids), np.stack([scene] * L),
            np.stack([nrm] * L), np.stack([svalid] * L))


def _assert_same(got, want):
    np.testing.assert_allclose(got.transform.numpy(), np.asarray(want.transform), atol=TOL)
    np.testing.assert_allclose(got.fitness.numpy(), np.asarray(want.fitness), atol=1e-7)
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


# ---------------------------------------------------------------------------
# point-to-plane, Levenberg-Marquardt, the schedules
# ---------------------------------------------------------------------------


def test_icp_plane_lanes_stop_where_the_reference_does():
    """`icp_plane` over four lanes (small, large, no perturbation, no model
    points) against the reference's vmapped while_loop."""
    m, mv, s, n, sv = _lanes(np.random.default_rng(11))
    kw = dict(max_iterations=40, max_corr_dist=0.05, rejection_dist=0.02,
              transform_epsilon=1e-5)
    want = jax.vmap(lambda *a: JI.icp_plane(*a, **kw))(
        *(jnp.asarray(a) for a in (m, mv, s, n, sv)))
    got = TI.icp_plane(*(t(a) for a in (m, mv, s, n, sv)), **kw)
    _assert_same(got, want)
    assert len(set(got.iterations.tolist())) > 1
    assert torch.equal(got.transform[3], torch.eye(4))
    assert got.iterations[3] == 1 and bool(got.converged[3]) and got.num_inliers[3] == 0


@pytest.mark.parametrize("stem", ["sweep_view00_clouds", "sweep_view45_clouds"])
@pytest.mark.parametrize("seed", range(2))
def test_icp_two_stage_plane_real_clouds(stem, seed):
    """The cascade's point-to-plane call (coarse pass capped at 40) on the
    real clouds with their normals; view 45 is the face-on single plane."""
    z = np.load(f"data/{stem}.npz")
    model = _perturb(z["model"], z["mvalid"], np.random.default_rng(seed), 3.0, 0.003)
    args = (model, z["mvalid"], z["scene"], z["snorm"], z["svalid"])
    kw = dict(coarse_iterations=40)
    want = JI.icp_two_stage_plane(*(jnp.asarray(a) for a in args), **kw)
    got = TI.icp_two_stage_plane(*(t(a) for a in args), **kw)
    _assert_same(got, want)


def test_icp_two_stage_plane_lanes():
    m, mv, s, n, sv = _lanes(np.random.default_rng(12))
    want = jax.vmap(lambda *a: JI.icp_two_stage_plane(*a, coarse_iterations=40))(
        *(jnp.asarray(a) for a in (m, mv, s, n, sv)))
    got = TI.icp_two_stage_plane(*(t(a) for a in (m, mv, s, n, sv)), coarse_iterations=40)
    _assert_same(got, want)
    assert len(set(got.iterations.tolist())) > 1


def test_icp_lm_lanes_stop_where_the_reference_does():
    """`icp_lm` (separate gates, lambda carried across outer iterations)
    over lanes that stop at different iterations, one of them empty."""
    m, mv, s, _, sv = _lanes(np.random.default_rng(13))
    kw = dict(max_iterations=50, max_corr_dist=0.05, rejection_dist=0.02)
    want = jax.vmap(lambda *a: JI.icp_lm(*a, **kw))(
        *(jnp.asarray(a) for a in (m, mv, s, sv)))
    got = TI.icp_lm(*(t(a) for a in (m, mv, s, sv)), **kw)
    _assert_same(got, want)
    assert len(set(got.iterations.tolist())) > 1
    assert torch.equal(got.transform[3], torch.eye(4))


@pytest.mark.parametrize("stem,seed,slack", [
    ("sweep_view00_clouds", 1, 0), ("sweep_view00_clouds", 3, 0),
    ("sweep_view45_clouds", 4, 0), ("sweep_view45_clouds", 3, 3),
])
def test_icp_nonlinear_schedule_real_clouds(stem, seed, slack):
    """The three-pass LM schedule on the real clouds.  Its epsilon of 1e-8
    (a 0.1 mm step) lies inside the jitter of the nearest-neighbour
    assignment on real samples, so a pass can end a few iterations apart
    when its start differs by an ulp: each pass alone, from identical
    points, stops where the reference's does (slack 0 also holds the
    whole schedule to that); view 45 at seed 3 ends at 39 against 40
    with the transform within 1.3e-5, held here within `slack`."""
    z = np.load(f"data/{stem}.npz")
    model = _perturb(z["model"], z["mvalid"], np.random.default_rng(seed), 3.0, 0.003)
    args = (model, z["mvalid"], z["scene"], z["svalid"])
    want = JI.icp_nonlinear_schedule(*(jnp.asarray(a) for a in args))
    got = TI.icp_nonlinear_schedule(*(t(a) for a in args))
    if slack == 0:
        _assert_same(got, want)
        return
    np.testing.assert_allclose(got.transform.numpy(), np.asarray(want.transform), atol=TOL)
    assert abs(int(got.iterations) - int(want.iterations)) <= slack
    pts_j, pts_t = jnp.asarray(model), t(model)
    for it, corr, rej in ((50, 0.05, 0.02), (20, 0.02, 0.01), (10, 0.005, 0.01)):
        kw = dict(max_iterations=it, max_corr_dist=corr, rejection_dist=rej)
        a = JI.icp_lm(pts_j, *(jnp.asarray(x) for x in args[1:]), **kw)
        _assert_same(TI.icp_lm(pts_t, *(t(x) for x in args[1:]), **kw), a)
        pts_j = pts_j @ a.transform[:3, :3].T + a.transform[:3, 3]
        pts_t = t(pts_j)


def test_icp_nonlinear_schedule_lanes():
    m, mv, s, _, sv = _lanes(np.random.default_rng(14))
    want = jax.vmap(JI.icp_nonlinear_schedule)(*(jnp.asarray(a) for a in (m, mv, s, sv)))
    got = TI.icp_nonlinear_schedule(*(t(a) for a in (m, mv, s, sv)))
    _assert_same(got, want)


def test_icp_schedule_lanes():
    """A three-stage Kabsch schedule: the last stage's fitness and inliers,
    summed iterations, converged if any stage was."""
    m, mv, s, _, sv = _lanes(np.random.default_rng(16))
    stages = ((30, 0.05, 0.02, 1e-5), (10, 0.02, 0.01, 1e-6), (5, 0.005, 0.01, 1e-7))
    want = jax.vmap(lambda *a: JI.icp_schedule(*a, stages))(
        *(jnp.asarray(a) for a in (m, mv, s, sv)))
    got = TI.icp_schedule(*(t(a) for a in (m, mv, s, sv)), stages)
    _assert_same(got, want)
    assert len(set(got.iterations.tolist())) > 1
    # the reference's record crosses as numpy, dtypes as the port's
    back = convert.icp_result_from_numpy(*(np.asarray(a) for a in want), device="cpu")
    assert [a.dtype for a in back] == [a.dtype for a in got]
    for a, b in zip(convert.record_to_numpy(back).values(), want):
        np.testing.assert_array_equal(a, np.asarray(b))


def _face_on(rng, n=384):
    """A face-on rectangle and a slightly rotated copy: the point-to-plane
    system alone is rank-deficient here."""
    xy = rng.uniform(-0.5, 0.5, size=(n, 2)) * (0.1, 0.06)
    tgt = np.concatenate([xy, np.full((n, 1), 0.5)], 1).astype(np.float32)
    cur = _perturb(tgt, np.ones(n, bool), rng, 2.0, 0.002)
    nrm = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (n, 1))
    return cur, tgt, nrm


@pytest.mark.parametrize("case", ["box", "face_on", "no_weight"])
def test_p2plane_delta_and_lm_step(case):
    rng = np.random.default_rng(len(case))
    if case == "face_on":
        cur, tgt, nrm = _face_on(rng)
    else:
        tgt, nrm = _box_with_normals(rng, 384)
        cur = _perturb(tgt, np.ones(384, bool), rng, 2.0, 0.002)
    w = (rng.random(384) < (0.0 if case == "no_weight" else 0.8)).astype(np.float32)
    tol = 1e-4 if case == "face_on" else 2e-5
    got = TI._p2plane_delta(t(cur), t(tgt), t(nrm), t(w)).numpy()
    want = np.asarray(JI._p2plane_delta(*(jnp.asarray(a) for a in (cur, tgt, nrm, w))))
    np.testing.assert_allclose(got, want, atol=tol)
    for lam in (1e-3, 10.0):
        got = TI._lm_step(t(cur), t(tgt), t(w), torch.tensor(lam)).numpy()
        want = np.asarray(JI._lm_step(jnp.asarray(cur), jnp.asarray(tgt), jnp.asarray(w),
                                      jnp.float32(lam)))
        np.testing.assert_allclose(got, want, atol=tol)
    if case == "no_weight":
        np.testing.assert_array_equal(got, np.eye(4, dtype=np.float32))
