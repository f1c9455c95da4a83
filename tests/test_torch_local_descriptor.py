"""PyTorch port vs the JAX reference: the neighbour graph and k-NN PCA
normals (ops/segmentation.py: knn_indices, estimate_normals) and every
stage of the local-descriptor pose (ops/local_descriptor.py), on CPU.

Inputs: an asymmetric L-shaped slab surface from a numpy seed (the shape
the reference's own test uses), rigidly moved for the scene, with padded
invalid slots; and a batch of lanes against the reference's vmap.

Tolerances: neighbour and keypoint indices, their validity masks, the
correspondences, vote counts and validity flags are equal; oriented
normals and frame axes within 1e-4 (eigenvectors from two LAPACK calls on
f32 covariances; compared after the reference's sign disambiguation, never
raw; a frame axis whose disambiguation sum lies within 2e-3 of zero,
relative to its absolute sum, may take either sign and is compared up to
sign: seed 0 has one at 1e-4, which flipped once in the reference under
another thread count), curvature within 1e-5; descriptors equal on at least 98 % of the
keypoints' slots (a support point that sits on a bin edge can fall either
side: a unit count moves) and within 0.35 in L2 norm everywhere; the pose
within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _xdist_threads  # noqa: F401  (PyTorch threads per xdist worker)

from linemod_pose_estimation_tpu.ops import local_descriptor as JL
from linemod_pose_estimation_tpu.ops import segmentation as JS
from linemod_pose_estimation_tpu_torch import convert
from linemod_pose_estimation_tpu_torch.ops import local_descriptor as TL
from linemod_pose_estimation_tpu_torch.ops import segmentation as TS

t = lambda a: torch.from_numpy(np.array(a))
j = jnp.asarray
N = 448


def _slab(rng, n=400):
    """An L-shaped slab surface — asymmetric, so the frames disambiguate."""
    plate = np.stack([rng.uniform(0, 0.08, n // 2), rng.uniform(0, 0.03, n // 2),
                      0.002 * rng.standard_normal(n // 2)], axis=1)
    wing = np.stack([rng.uniform(0, 0.02, n // 2), rng.uniform(0, 0.03, n // 2),
                     rng.uniform(0, 0.05, n // 2)], axis=1)
    return np.concatenate([plate, wing]).astype(np.float32)


def _rot(axis, deg):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    a = np.radians(deg)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return (np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K).astype(np.float32)


def _pair(seed, n_valid=400):
    """(model, mvalid, scene, svalid): N slots, the first n_valid real, the
    scene the model moved rigidly to ~0.5 m, the rest at the sentinel."""
    rng = np.random.default_rng(seed)
    model = np.full((N, 3), 1e6, np.float32)
    model[:400] = _slab(rng) + [0.0, 0.0, 0.5]
    valid = np.arange(N) < n_valid
    R, shift = _rot([0.2, 0.5, 1.0], 35.0), np.array([0.04, 0.07, -0.02], np.float32)
    c = model[:400].mean(0)
    scene = np.where(valid[:, None], (model - c) @ R.T + c + shift, 1e6).astype(np.float32)
    model = np.where(valid[:, None], model, 1e6).astype(np.float32)
    return model, valid, scene, valid.copy()


@pytest.mark.parametrize("k", [10, 50])
def test_knn_indices(k):
    """Nearest-first neighbours; duplicated points tie (the lower index
    first), and rows of invalid points tie at infinity."""
    pts, valid, *_ = _pair(0, n_valid=380)
    pts[5] = pts[3]
    pts[9] = pts[3]
    want = JS.knn_indices(j(pts), j(valid), k)
    got = TS.knn_indices(t(pts), t(valid), k)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


def test_knn_indices_few_points():
    """Fewer valid points than k: the missing neighbours are invalid and
    take the lowest indices, as the reference's top_k over -inf does."""
    pts, valid, *_ = _pair(1, n_valid=6)
    want = JS.knn_indices(j(pts), j(valid), 10)
    got = TS.knn_indices(t(pts), t(valid), 10)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[1][0].sum()) == 5


@pytest.mark.parametrize("seed", range(2))
def test_estimate_normals(seed):
    pts, valid, scene, _ = _pair(seed, n_valid=390)
    for cloud in (pts, scene):
        want_n, want_c = JS.estimate_normals(j(cloud), j(valid), k=10)
        got_n, got_c = TS.estimate_normals(t(cloud), t(valid), k=10)
        v = valid
        np.testing.assert_allclose(got_n.numpy()[v], np.asarray(want_n)[v], atol=1e-4)
        np.testing.assert_allclose(got_c.numpy()[v], np.asarray(want_c)[v], atol=1e-5)
        assert np.all(np.sum(got_n.numpy()[v] * cloud[v], axis=1) <= 0)  # towards the origin


@pytest.mark.parametrize("k_cap", [96, 16])
def test_select_keypoints(k_cap):
    """First point of each voxel, voxels in hash order, to a cap that holds
    them all and to one that truncates."""
    pts, valid, *_ = _pair(2, n_valid=390)
    want = JL.select_keypoints(j(pts), j(valid), 0.008, k_cap)
    got = TL.select_keypoints(t(pts), t(valid), 0.008, k_cap)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[0].dtype == torch.int32 and int(got[1].sum()) > 10


def _stages(mod, a, pts, valid, normals_of):
    """(kp idx, kp valid, frames, descriptors) of one cloud through `mod`."""
    normals, _ = normals_of(a(pts), a(valid), k=10)
    ki, kv = mod.select_keypoints(a(pts), a(valid), 0.008, 96)
    lrf = mod.local_reference_frames(a(pts), a(valid), ki, 0.015)
    desc = mod.shot_descriptors(a(pts), a(valid), normals, ki, kv, lrf, 0.02)
    return ki, kv, lrf, desc


def _assert_descriptors(got, want, kv):
    got, want = got[kv], want[kv]
    assert np.mean(got == want) >= 0.98
    assert np.linalg.norm(got - want, axis=1).max() <= 0.35
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def _sign_margin(cloud, valid, ki, lrf, radius=0.015):
    """Per keypoint, how far the frame's sign disambiguation is from a
    tie: min over the x and z axes of |sum w p| / sum w |p|, p the support
    projected on the axis (float64)."""
    kp = cloud[ki]
    diff = (cloud[None] - kp[:, None]).astype(np.float64)
    w = np.maximum(radius - np.linalg.norm(diff, axis=-1), 0) * valid[None]
    out = []
    for ax in (0, 2):
        p = np.einsum("kni,ki->kn", diff, lrf[:, ax].astype(np.float64))
        out.append(np.abs((w * p).sum(1)) / np.maximum((w * np.abs(p)).sum(1), 1e-30))
    return np.minimum(*out)


@pytest.mark.parametrize("seed,n_valid", [(0, 395), (1, 395), (3, 400)])
def test_frames_and_descriptors(seed, n_valid):
    model, valid, scene, _ = _pair(seed, n_valid=n_valid)
    for cloud in (model, scene):
        ki_j, kv_j, lrf_j, d_j = _stages(JL, j, cloud, valid, JS.estimate_normals)
        ki_t, kv_t, lrf_t, d_t = _stages(TL, t, cloud, valid, TS.estimate_normals)
        kv = np.asarray(kv_j)
        np.testing.assert_array_equal(kv_t.numpy(), kv)
        np.testing.assert_array_equal(ki_t.numpy(), np.asarray(ki_j))
        lrf_j, lrf_t = np.asarray(lrf_j), lrf_t.numpy()
        firm = kv & (_sign_margin(cloud, valid, np.asarray(ki_j), lrf_j) > 2e-3)
        assert firm.sum() >= 0.9 * kv.sum()
        np.testing.assert_allclose(lrf_t[firm], lrf_j[firm], atol=1e-4)
        loose = kv & ~firm
        np.testing.assert_allclose(np.abs(lrf_t[loose][:, [0, 2]]),
                                   np.abs(lrf_j[loose][:, [0, 2]]), atol=1e-4)
        _assert_descriptors(d_t.numpy(), np.asarray(d_j), firm)
        # a right-handed orthonormal frame per keypoint
        F = lrf_t[kv]
        np.testing.assert_allclose(F @ F.transpose(0, 2, 1), np.broadcast_to(np.eye(3), F.shape),
                                   atol=1e-4)
        np.testing.assert_allclose(np.linalg.det(F), 1.0, atol=1e-4)


def test_match_descriptors_and_hough_pose():
    """The reference's descriptors and frames through both packages'
    matching and voting: identical inputs, so the correspondences, the
    winning cell and the flags are equal; duplicated model descriptors tie
    (the first wins)."""
    model, valid, scene, _ = _pair(3)
    mki, mkv, mlrf, md = _stages(JL, j, model, valid, JS.estimate_normals)
    ski, skv, slrf, sd = _stages(JL, j, scene, valid, JS.estimate_normals)
    md = md.at[7].set(md[2])
    corr_j, cok_j = JL.match_descriptors(sd, skv, md, mkv)
    corr_t, cok_t = TL.match_descriptors(t(sd), t(skv), t(md), t(mkv))
    np.testing.assert_array_equal(corr_t.numpy(), np.asarray(corr_j))
    np.testing.assert_array_equal(cok_t.numpy(), np.asarray(cok_j))
    assert int(cok_t.sum()) >= 5
    ref = np.asarray(model[valid].mean(0), np.float32)
    args = (np.asarray(scene)[np.asarray(ski)], np.asarray(model)[np.asarray(mki)], slrf, mlrf,
            ref, corr_j, cok_j)
    want = JL.hough_pose(*(j(a) for a in args), 0.01, 5)
    got = TL.hough_pose(*(t(a) for a in args), 0.01, 5)
    assert (int(got.votes), int(got.n_correspondences), bool(got.valid)) == (
        int(want.votes), int(want.n_correspondences), bool(want.valid))
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=1e-4)
    # no correspondence at all: the identity, zero votes, not valid
    none = TL.hough_pose(*(t(a) for a in args[:6]), t(np.zeros_like(cok_j)), 0.01, 5)
    np.testing.assert_array_equal(none.pose.numpy(), np.eye(4, dtype=np.float32))
    assert int(none.votes) == 0 and not bool(none.valid)


@pytest.mark.parametrize("seed", [0, 1, 3])
def test_get_pose_by_local_descriptor(seed):
    """The whole chain: the pose is the planted one and agrees with the
    reference's; votes, correspondences and validity are equal."""
    model, valid, scene, svalid = _pair(seed)
    kw = dict(keypoint_leaf=0.008, k_cap=96, min_votes=5)
    want = JL.get_pose_by_local_descriptor(j(model), j(valid), j(scene), j(svalid), **kw)
    got = TL.get_pose_by_local_descriptor(t(model), t(valid), t(scene), t(svalid), **kw)
    assert (int(got.votes), int(got.n_correspondences), bool(got.valid)) == (
        int(want.votes), int(want.n_correspondences), bool(want.valid))
    assert bool(got.valid)
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=1e-4)
    moved = model[valid] @ got.pose.numpy()[:3, :3].T + got.pose.numpy()[:3, 3]
    assert np.abs(moved - scene[valid]).max() < 0.005


def test_local_descriptor_lanes_and_records():
    """Three lanes in one batch (a pair, an unrelated scene, an empty
    model) against the reference's vmap; the record crosses as numpy."""
    rng = np.random.default_rng(9)
    pairs = [_pair(5), _pair(1), _pair(6, n_valid=0)]
    noise = rng.uniform(-0.1, 0.1, size=(N, 3)).astype(np.float32) + [0, 0, 0.5]
    pairs[1] = (pairs[1][0], pairs[1][1], noise.astype(np.float32), pairs[1][3])
    args = [np.stack(a) for a in zip(*pairs)]
    kw = dict(keypoint_leaf=0.008, k_cap=96, min_votes=5)
    want = jax.vmap(lambda *a: JL.get_pose_by_local_descriptor(*a, **kw))(*(j(a) for a in args))
    got = TL.get_pose_by_local_descriptor(*(t(a) for a in args), **kw)
    for name in ("votes", "n_correspondences", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert got.valid.tolist() == [True, False, False]
    np.testing.assert_allclose(got.pose[0].numpy(), np.asarray(want.pose[0]), atol=1e-4)
    back = convert.local_descriptor_pose_from_numpy(*(np.asarray(a) for a in want), device="cpu")
    assert back.votes.dtype == torch.int32 and back.valid.dtype == torch.bool
    for a, b in zip(convert.record_to_numpy(back).values(), want):
        np.testing.assert_array_equal(a, np.asarray(b))
