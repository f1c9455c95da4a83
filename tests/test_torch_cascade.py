"""PyTorch port vs the JAX reference: the detection cascade
(models/cascade.py) and DetectionPipeline.detect (models/pipeline.py),
on CPU.

The stages run on seeded inputs; the whole detect runs at 160x120 with
the focal lengths / 4 (as tests/test_cascade.py does) on a bank the
reference trains from renders of the cuboid stand-in for the boxNew mesh,
carried across with ``convert.py``, with default CascadeParams and in the
six non-default configurations of ``GOLDEN_OPTION_SETS`` (the accuracy
configuration, a refinement round, LM ICP, the three other position
strategies).  The slow tests hold the port's CPU detect against
``tests/data/torch_cascade_golden.npz`` and
``tests/data/torch_cascade_options_golden.npz`` at full width.

Tolerances: matches, vote cells, member lists, NMS, cluster order,
detection validity and rects are equal; scores within 1e-4; poses within
0.25 degrees and 0.5 mm (ICP iterates to convergence from identical
clouds, but the reference's CPU XLA sums and fuses in its own order, so
nearest-neighbour ties and the convergence step can differ: measured
0.00-0.08 degrees and < 0.04 mm on the full-width frames).  The in-plane
sweep's T_fix within 2e-5 of the reference's on the synthetic rectangle
and on the two real clouds, where both pick the same sweep angles; its
`applied` flag, the NMS keep masks and the hypothesis choice are equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _xdist_threads  # noqa: F401  (PyTorch threads per xdist worker)

from linemod_pose_estimation_tpu.models import cascade as JC
from linemod_pose_estimation_tpu.models import renderer as JR
from linemod_pose_estimation_tpu.models.detector import Detector as JDetector
from linemod_pose_estimation_tpu.models.pipeline import DetectionPipeline as JPipe
from linemod_pose_estimation_tpu.models.templates import DetectorParams as JParams
from linemod_pose_estimation_tpu.models.templates import TemplateBank as JBank
from linemod_pose_estimation_tpu.models.templates import TemplateMetadata as JMeta
from linemod_pose_estimation_tpu.ops.match import Matches as JMatches
from linemod_pose_estimation_tpu.utils import geometry as JG
from linemod_pose_estimation_tpu.utils import pointcloud as JP
from linemod_pose_estimation_tpu_torch import convert
from linemod_pose_estimation_tpu_torch.models import cascade as TC
from linemod_pose_estimation_tpu_torch.models.pipeline import DetectionPipeline as TPipe
from linemod_pose_estimation_tpu_torch.utils import geometry as TG
from linemod_pose_estimation_tpu_torch.utils import pointcloud as TP
from linemod_pose_estimation_tpu_torch.utils.scenes import cuboid_mesh

PARAMS = "data/boxNew_rgbd_params.yml.gz"
BANK = "data/boxNew_rgbd_templates.yml.gz"
GOLDEN = "tests/data/torch_cascade_golden.npz"
OPTIONS_GOLDEN = "tests/data/torch_cascade_options_golden.npz"
W, H = 160, 120
DEG_TOL, MM_TOL = 0.25, 0.5
t = lambda a: torch.from_numpy(np.array(a))


def _pose_err(a, b):
    """(degrees, mm) between two (4, 4) poses."""
    deg = float(TG.rotation_geodesic_deg(t(a[:3, :3]).float(), t(b[:3, :3]).float()))
    return deg, 1000.0 * float(np.linalg.norm(np.asarray(a)[:3, 3] - np.asarray(b)[:3, 3]))


def _seeded_matches(seed, K=128, n_tpl=2652):
    """Best-first matches around four positions (some cells tiny, some
    overfull), part invalid."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(40, 400, size=(4, 2))
    which = rng.integers(0, 4, K)
    xy = centers[which] + rng.integers(-12, 13, size=(K, 2))
    sim = np.sort(rng.uniform(85, 100, K).astype(np.float32))[::-1].copy()
    sim[10:14] = sim[10]  # equal similarities
    tid = rng.integers(0, n_tpl, K).astype(np.int32)
    valid = np.arange(K) < K - 20
    return [tid, xy[:, 0].astype(np.int32), xy[:, 1].astype(np.int32), sim, valid]


@pytest.fixture(scope="module")
def meta():
    return JBank.read_params_yaml(PARAMS)


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_cluster_matches_and_nms(meta, seed):
    m, glob = meta
    f = _seeded_matches(seed)
    od = m.Ori_dist.astype(np.float32)
    rects = m.Rect.astype(np.int32)
    args = (glob.radius_min, glob.radius_step, 20, 2, 16, 8)
    cj = JC.cluster_matches(JMatches(*(jnp.asarray(a) for a in f)), jnp.asarray(od),
                            jnp.asarray(rects), *args)
    ct = TC.cluster_matches(convert.matches_from_numpy(*f, device="cpu"), t(od), t(rects), *args)
    for name in ("count", "bbox", "valid", "member_idx", "member_valid"):
        np.testing.assert_array_equal(getattr(ct, name).numpy(),
                                      np.asarray(getattr(cj, name)), err_msg=name)
    np.testing.assert_allclose(ct.score.numpy(), np.asarray(cj.score), atol=1e-4)
    assert int(ct.valid.sum()) >= 2
    np.testing.assert_array_equal(TC.nms_iou(ct, 0.4).numpy(),
                                  np.asarray(JC.nms_iou(cj, 0.4)))


@pytest.mark.parametrize("seed", range(3))
def test_nms_iou_overlaps_and_ties(seed):
    """Heavily overlapping boxes with tied scores: the stable order and
    strict-rank suppression of the reference."""
    rng = np.random.default_rng(50 + seed)
    C = 12
    bbox = np.concatenate([rng.integers(0, 60, (C, 2)), rng.integers(20, 50, (C, 2))],
                          1).astype(np.float32)
    score = rng.choice([90.0, 92.5, 95.0], C).astype(np.float32)
    valid = rng.random(C) < 0.85
    fields = dict(score=np.where(valid, score, -1.0).astype(np.float32),
                  count=np.full(C, 3, np.int32), bbox=bbox, valid=valid,
                  member_idx=np.zeros((C, 4), np.int32),
                  member_valid=np.zeros((C, 4), bool))
    want = JC.nms_iou(JC.ClusterSet(**{k: jnp.asarray(v) for k, v in fields.items()}), 0.4)
    got = TC.nms_iou(TC.ClusterSet(**{k: t(v) for k, v in fields.items()}), 0.4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_hyp", [1, 2])
def test_orientation_cluster_average(meta, n_hyp):
    """Three lanes of 64 members drawn around a few bank orientations
    (some members past the seed threshold), a lane with no members."""
    m, _ = meta
    rng = np.random.default_rng(7)
    C, M = 3, 64
    q_bank = np.asarray(JG.quat_from_matrix(jnp.asarray(m.R.astype(np.float32))))
    tids = rng.choice([0, 1, 2, 40, 41, 700], size=(C, M))
    quats = q_bank[tids] * rng.choice([-1.0, 1.0], size=(C, M, 1)).astype(np.float32)
    Ts = m.T[tids].astype(np.float32)
    Ds, Ods = m.D[tids].astype(np.float32), m.Ori_dist[tids].astype(np.float32)
    xs = rng.integers(100, 300, (C, M)).astype(np.float32)
    ys = rng.integers(100, 300, (C, M)).astype(np.float32)
    sims = rng.uniform(85, 100, (C, M)).astype(np.float32)
    mvalid = np.arange(M)[None, :] < np.array([[64], [20], [0]])
    args = (quats, Ts, Ds, Ods, xs, ys, sims, mvalid)
    want = jax.vmap(lambda *a: JC._orientation_cluster_average(*a, 10.0, 16, n_hyp=n_hyp))(
        *(jnp.asarray(a) for a in args))
    got = TC._orientation_cluster_average(*(t(a) for a in args), 10.0, 16, n_hyp=n_hyp)
    for i, (a, b) in enumerate(zip(got, want)):
        if a.dtype in (torch.int32, torch.int64):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=str(i))
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, err_msg=str(i))


@pytest.mark.parametrize("case", ["inside", "edge", "off"])
def test_scene_window_extract(case):
    """Transplanted mask windows (clipped by the frame edge, or fully
    off-frame), dilation and strided compaction against the reference."""
    rng = np.random.default_rng(len(case))
    Hs, Ws, mh, mw = 60, 80, 32, 32
    cloud = rng.normal(scale=0.05, size=(Hs, Ws, 3)).astype(np.float32) + [0, 0, 0.7]
    cloud[rng.random((Hs, Ws)) < 0.1] = np.nan
    cloud = cloud.astype(np.float32)
    masks, rects, X, Y = [], [], [], []
    for lane in range(3):
        mk = np.zeros((mh, mw), np.uint8)
        y0, x0 = rng.integers(0, 10, 2)
        h, w = rng.integers(8, 20, 2)
        mk[y0:y0 + h, x0:x0 + w] = 255
        masks.append(mk)
        rects.append([x0, y0, w, h])
        if case == "inside":
            X.append(rng.integers(10, 50)), Y.append(rng.integers(10, 30))
        elif case == "edge":
            X.append(Ws - 8 - 2 * lane), Y.append(-4 + lane)
        else:
            X.append(Ws + 40), Y.append(Hs + 40)
    masks, rects = np.stack(masks), np.array(rects, np.int32)
    X, Y = np.array(X, np.int32), np.array(Y, np.int32)
    for cap in (512, 64):
        want = jax.vmap(lambda mk, r, x, y: JC._windowed_scene_extract(
            jnp.asarray(cloud), None, mk, r, x, y, 2, cap)[:2])(
            jnp.asarray(masks), jnp.asarray(rects), jnp.asarray(X), jnp.asarray(Y))
        got = TC._windowed_scene_extract(t(cloud), t(masks), t(rects), t(X), t(Y), 2, cap)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    if case == "off":
        assert not bool(got[1].any())
    else:
        assert int(got[1].sum()) > 0
    dil_j = JC.dilate_mask(jnp.asarray(masks[0] > 0), 3)
    np.testing.assert_array_equal(TC.dilate_mask(t(masks[0] > 0), 3).numpy(),
                                  np.asarray(dil_j))


def _canonicalize_reference(R, mode):
    """The reference's lax.cond branches (cascade.py, _pose_one_hypothesis)
    restated on one numpy rotation."""
    R = R.copy()
    if mode == "x_front":
        if R[0, 0] < 0:
            R[:, 0] = -R[:, 0]
            if R[1, 1] > 0:
                R[:, 1] = -R[:, 1]
            else:
                R[:, 2] = -R[:, 2]
        elif R[1, 1] > 0:
            R[:, 1] = -R[:, 1]
            R[:, 2] = -R[:, 2]
    elif mode == "z_down" and R[2, 2] < 0:
        R[:, 0] = -R[:, 0]
        R[:, 2] = -R[:, 2]
    return R


@pytest.mark.parametrize("mode", ["x_front", "z_down", "none"])
def test_canonicalize(mode):
    q = np.random.default_rng(9).normal(size=(64, 4)).astype(np.float32)
    R = TG.quat_to_matrix(t(q)).numpy()
    got = TC.canonicalize(t(R), mode).numpy()
    want = np.stack([_canonicalize_reference(r, mode) for r in R])
    np.testing.assert_array_equal(got, want)
    assert np.allclose(np.linalg.det(got), 1.0, atol=1e-5)


@pytest.mark.parametrize("option", [
    dict(icp_variant="point_to_plane"), dict(icp_variant="nonlinear"),
    dict(position_strategy="roi_center"), dict(position_strategy="local_descriptor"),
    dict(orientation_hypotheses=2), dict(nms_after_pose=True), dict(refine_rounds=1),
    TC.ACCURACY_OPTIONS, dict(icp_variant="no_such_variant"),
    dict(position_strategy="no_such_strategy"),
])
def test_non_default_options_construct(meta, option):
    """Every value of CascadeParams the reference takes builds a pipeline
    (an unknown variant or strategy falls through to the default one at
    detect time, as in the reference)."""
    m, glob = meta
    det = convert.detector_from_reference(JBank("box", JParams(), []), device="cpu")
    pipe = TPipe(det, convert.metadata_from_reference(m), convert.globals_from_reference(glob),
                 cuboid_mesh(), TC.CascadeParams(**option))
    assert not hasattr(TC, "check_ported")
    np.testing.assert_array_equal(
        pipe.K_frame.numpy(),
        np.array([[glob.focal_length_x, 0, glob.width / 2], [0, glob.focal_length_y,
                  glob.height / 2], [0, 0, 1]], np.float32))
    cloud = torch.full((4, 5, 3), torch.nan)
    assert (pipe.scene_normals(cloud) is None) == (option.get("icp_variant") != "point_to_plane")


def test_cascade_params_defaults_match_reference():
    assert dataclasses.asdict(TC.CascadeParams()) == dataclasses.asdict(JC.CascadeParams())


# ---------------------------------------------------------------------------
# the stages of the non-default options
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_voxel_grid_filter_aux(seed):
    """Per-voxel mean normals ride along with the centroids, lanes against
    the reference's vmap; without aux the two-tuple stays."""
    rng = np.random.default_rng(60 + seed)
    L, N, cap = 3, 256, 128 if seed else 16
    pts = (rng.uniform(-0.02, 0.02, size=(L, N, 3)) + [0, 0, 0.6]).astype(np.float32)
    aux = rng.normal(size=(L, N, 3)).astype(np.float32)
    valid = rng.random((L, N)) < 0.8
    valid[2] = False
    want = jax.vmap(lambda p, v, a: JP.voxel_grid_filter(p, v, 0.004, cap, aux=a))(
        jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(aux))
    got = TP.voxel_grid_filter(t(pts), t(valid), 0.004, cap, aux=t(aux))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-6)
    assert not bool(got[2][~got[1]].any())
    two = TP.voxel_grid_filter(t(pts), t(valid), 0.004, cap)
    assert len(two) == 2 and torch.equal(two[0], got[0])


@pytest.mark.parametrize("cap", [512, 64])
def test_scene_window_extract_with_normals(cap):
    """The normals of the compacted scene points, strided where the mask
    holds more than the cap."""
    rng = np.random.default_rng(cap)
    Hs, Ws = 60, 80
    cloud = (rng.normal(scale=0.05, size=(Hs, Ws, 3)) + [0, 0, 0.7]).astype(np.float32)
    cloud[rng.random((Hs, Ws)) < 0.1] = np.nan
    normals = rng.normal(size=(Hs, Ws, 3)).astype(np.float32)
    masks = np.zeros((2, 32, 32), np.uint8)
    masks[0, 4:20, 6:22] = 255
    masks[1, 0:12, 10:30] = 255
    rects = np.array([[6, 4, 16, 16], [10, 0, 20, 12]], np.int32)
    X, Y = np.array([30, 70], np.int32), np.array([20, 50], np.int32)
    want = jax.vmap(lambda mk, r, x, y: JC._windowed_scene_extract(
        jnp.asarray(cloud), jnp.asarray(normals), mk, r, x, y, 2, cap))(
        jnp.asarray(masks), jnp.asarray(rects), jnp.asarray(X), jnp.asarray(Y))
    got = TC._windowed_scene_extract(t(cloud), t(masks), t(rects), t(X), t(Y), 2, cap,
                                     scene_normals=t(normals))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(got[1].sum()) > 0 and not bool(got[2][~got[1]].any())


@pytest.mark.parametrize("seed", range(4))
def test_nms_rects_with_tied_keys(seed):
    """Posed rects ranked by a key with ties (the stable order keeps the
    lower lane first), -inf keys and invalid lanes."""
    rng = np.random.default_rng(70 + seed)
    C = 8
    rects = np.concatenate([rng.integers(100, 140, (C, 2)), rng.integers(40, 70, (C, 2))],
                           1).astype(np.int32)
    rects[1] = rects[0]  # two lanes on one rect with one key
    key = rng.choice([99.5, 100.25, 101.0], C).astype(np.float32)
    key[1] = key[0]
    if seed == 3:
        key[:] = 100.0
    valid = rng.random(C) < 0.8
    valid[:2] = True
    want = JC.nms_rects(jnp.asarray(rects), jnp.asarray(key), jnp.asarray(valid), 0.4)
    got = TC.nms_rects(t(rects), t(key), t(valid), 0.4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not bool(got[1])  # the twin of lane 0 never survives


def test_select_hypothesis():
    """-inf keys for empty or invalid hypotheses, the first maximum on
    ties, slot 0 where no key is finite — against the reference's rule
    restated on numpy."""
    rng = np.random.default_rng(3)
    C, n_hyp = 6, 2
    f = lambda *shape: rng.uniform(0.1, 1.0, size=(C, n_hyp) + shape).astype(np.float32)
    poses = TC.ClusterPose(
        pose=t(f(4, 4)), rect=t(rng.integers(0, 99, (C, n_hyp, 4)).astype(np.int32)),
        score=t(f()), icp_fitness=t(f() * 1e-5), hv_rate=t(f()),
        valid=t(np.array([[1, 1], [1, 0], [0, 1], [0, 0], [1, 1], [1, 1]], bool)),
        rough_pose=t(f(4, 4)), hyp_sim=t(90 + 10 * f()))
    cnt = t(np.array([[9, 4], [9, 4], [9, 4], [9, 4], [9, 0], [5, 5]], np.int32))
    for name in ("hyp_sim", "hv_rate", "icp_fitness"):  # lane 5: tied keys
        getattr(poses, name)[5, 1] = getattr(poses, name)[5, 0]
    got = TC.select_hypothesis(poses, cnt)
    key = np.where((cnt.numpy() > 0) & poses.valid.numpy(),
                   (poses.hyp_sim + poses.hv_rate - 1e4 * poses.icp_fitness).numpy(), -np.inf)
    b = np.where(np.isfinite(key).any(1), key.argmax(1), 0)
    assert b[1] == 0 and b[2] == 1 and b[3] == 0 and b[4] == 0 and b[5] == 0
    for a, full in zip(got, poses):
        np.testing.assert_array_equal(a.numpy(), full.numpy()[np.arange(C), b])


def test_median_of_an_even_count():
    """The plane depth is the mean of the two middle values for an even
    count (jnp.nanmedian); torch.nanmedian would take the lower one, which
    moves the 5 mm band and with it the points the bbox sweep keeps."""
    vals = np.array([[0.4995, 0.502, 0.508, 0.5095, 9.0, 9.0],
                     [0.3, 0.1, 0.2, 9.0, 9.0, 9.0],
                     [9.0, 9.0, 9.0, 9.0, 9.0, 9.0]], np.float32)
    valid = np.array([[1, 1, 1, 1, 0, 0], [1, 1, 1, 0, 0, 0], [0, 0, 0, 0, 0, 0]], bool)
    got = TC._median(t(vals), t(valid)).numpy()
    want = np.asarray(jnp.nanmedian(jnp.where(jnp.asarray(valid), jnp.asarray(vals), jnp.nan),
                                    axis=1))
    np.testing.assert_array_equal(got, want)
    assert got[0] == (np.float32(0.502) + np.float32(0.508)) / 2
    assert got[1] == np.float32(0.2) and np.isnan(got[2])
    lower = float(torch.nanmedian(torch.where(t(valid[0]), t(vals[0]), torch.nan)))
    assert lower == np.float32(0.502)
    # the band |depth - med| < 5 mm keeps the upper three points around
    # 0.505, and only the lower two around 0.502
    assert int((np.abs(vals[0, :4] - got[0]) < TC.PLANE_EPS).sum()) == 3
    assert int((np.abs(vals[0, :4] - lower) < TC.PLANE_EPS).sum()) == 2


def test_sweep_angles_equal_the_reference_grid():
    """The 181 and 21 sweep angles against jnp.linspace: the same f32
    expression, which the reference's CPU XLA evaluates fused (up to 3 ulp
    away at 0.785 rad, 1e-5 degrees); the endpoints are exact.  That the
    argmin lands on the same angle shows in the T_fix comparisons below:
    one step of the fine grid would move T_fix by 8.7e-4."""
    for a, b, n in ((-np.pi / 4, np.pi / 4, TC.SWEEP_COARSE),
                    (-np.pi / 360, np.pi / 360, TC.SWEEP_FINE)):
        got = TC._linspace(a, b, n, "cpu").numpy()
        want = np.asarray(jnp.linspace(a, b, n))
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)
        assert got[0] == want[0] and got[-1] == want[-1] and got.dtype == np.float32


def _rectangle(deg, n_valid=384, cap=512):
    """The reference test's face-on 10 x 6 cm rectangle at z = 0.5 and a
    copy rotated by `deg` about z through its centroid, padded to `cap`."""
    xs, ys = np.meshgrid(np.linspace(-0.05, 0.05, 24), np.linspace(-0.03, 0.03, 16))
    scene = np.stack([xs.ravel(), ys.ravel(), np.full(xs.size, 0.5)], 1).astype(np.float32)
    th = np.deg2rad(deg)
    Rz = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]],
                  np.float32)
    c = scene.mean(0)
    pad = np.zeros((cap - len(scene), 3), np.float32)
    model = np.concatenate([(scene - c) @ Rz.T + c, pad])
    valid = np.arange(cap) < n_valid
    normals = np.tile(np.array([[0, 0, 1]], np.float32), (cap, 1))
    return model, valid, np.concatenate([scene, pad]), normals, valid.copy(), Rz


def _sweep_both(args, sweep_deg=6.0, dominance=0.95):
    want = JC.inplane_sweep_fix(*(jnp.asarray(a) for a in args), jnp.asarray(True),
                                sweep_deg=sweep_deg, dominance=dominance)
    got = TC.inplane_sweep_fix(*(t(a) for a in args), torch.tensor(True),
                               sweep_deg=sweep_deg, dominance=dominance)
    assert bool(got[1]) == bool(want[1])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=2e-5)
    return got


def test_inplane_sweep_recovers_face_on_rotation():
    """The reference's synthetic case: a 3 degree in-plane offset on one
    visible plane is repaired; an aligned pair and a two-plane scene are
    left alone."""
    model, mv, scene, sn, sv, Rz = _rectangle(3.0)
    T_fix, applied = _sweep_both((model, mv, scene, sn, sv))
    assert bool(applied)
    assert float(TG.rotation_geodesic_deg(t(Rz.T), T_fix[:3, :3])) < 0.5
    fixed = model @ T_fix.numpy()[:3, :3].T + T_fix.numpy()[:3, 3]
    assert np.abs(fixed[sv] - scene[sv]).max() < 1.5e-3
    T_id, applied0 = _sweep_both((scene, mv, scene, sn, sv))
    assert not bool(applied0)
    np.testing.assert_allclose(T_id.numpy(), np.eye(4), atol=1e-5)
    sn2 = sn.copy()
    sn2[:192] = [1.0, 0.0, 0.0]
    assert not bool(_sweep_both((model, mv, scene, sn2, sv))[1])


@pytest.mark.parametrize("stem,true_deg", [("sweep_view45_clouds", 3.02),
                                           ("sweep_view00_clouds", 1.35)])
def test_inplane_sweep_real_failing_views(stem, true_deg):
    """The two real tail views: a correction within 0.5 degrees of the
    truth, and T_fix within 2e-5 of the reference's own."""
    z = np.load(f"data/{stem}.npz")
    args = (z["model"], z["mvalid"], z["scene"], z["snorm"], z["svalid"])
    T_fix, applied = _sweep_both(args, dominance=0.7)
    assert bool(applied)
    R = T_fix.numpy()[:3, :3]
    ang = np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))
    assert abs(ang - true_deg) < 0.5, f"correction {ang} deg vs {true_deg}"


def test_inplane_sweep_lanes():
    """Five lanes in one batch against the reference lane by lane: the
    two real views, the rectangle at 3 degrees with an even and an odd
    count of points, an inactive lane and a lane with no points."""
    lanes = []
    for stem in ("sweep_view45_clouds", "sweep_view00_clouds"):
        z = np.load(f"data/{stem}.npz")
        lanes.append([z[k] for k in ("model", "mvalid", "scene", "snorm", "svalid")] + [True])
    for n_valid, active in ((384, True), (383, True), (384, False), (0, True)):
        model, mv, scene, sn, sv, _ = _rectangle(3.0, n_valid, cap=1024)
        lanes.append([model, mv, scene, sn, sv, active])
    args = [np.stack(a) for a in zip(*lanes)]
    got_T, got_applied = TC.inplane_sweep_fix(*(t(a) for a in args), 6.0, 0.7)
    for i, lane in enumerate(lanes):
        want = JC.inplane_sweep_fix(*(jnp.asarray(a) for a in lane), 6.0, 0.7)
        assert bool(got_applied[i]) == bool(want[1]), i
        np.testing.assert_allclose(got_T[i].numpy(), np.asarray(want[0]), atol=2e-5,
                                   err_msg=str(i))
    assert got_applied.tolist() == [True, True, True, True, False, False]


# ---------------------------------------------------------------------------
# the whole detect at 160 x 120
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pipelines(meta):
    meta_full, glob = JBank.read_params_yaml(PARAMS)
    glob.width, glob.height = W, H
    glob.focal_length_x /= 4
    glob.focal_length_y /= 4
    mesh = cuboid_mesh()
    tris = jnp.asarray(JR._pad_triangles(mesh.triangles, 64))
    K = jnp.array([[glob.focal_length_x, 0, W / 2], [0, glob.focal_length_y, H / 2],
                   [0, 0, 1]], jnp.float32)
    render = lambda i: JR.render(tris, jnp.asarray(meta_full.R[i], jnp.float32),
                                 jnp.asarray(meta_full.T[i], jnp.float32), K, W, H)
    jdet = JDetector(JParams())
    kept = []
    for i in (40, 41, 42, 700, 1400):
        out = render(i)
        if jdet.add_template(np.asarray(out.rgb), np.asarray(out.mask), "box") >= 0:
            kept.append(i)
    assert len(kept) >= 3
    jmeta = JMeta(R=meta_full.R[kept], T=meta_full.T[kept], K=meta_full.K[kept],
                  D=meta_full.D[kept], Ori_dist=meta_full.Ori_dist[kept],
                  Rect=meta_full.Rect[kept])
    kw = dict(max_clusters=2, model_cap=512, scene_cap=512, icp_max_iter=40,
              cluster_filter_thresh=0)
    jpipe = JPipe(jdet, jmeta, glob, mesh, JC.CascadeParams(**kw), render_size=(W, H))
    tpipe = TPipe(convert.detector_from_reference(jdet.bank("box"), device="cpu"),
                  convert.metadata_from_reference(jmeta), convert.globals_from_reference(glob),
                  mesh, TC.CascadeParams(**kw), render_size=(W, H))
    scene = render(kept[0])
    cloud = np.asarray(JP.depth_to_cloud(scene.depth_mm / 1000.0, K))
    return jpipe, tpipe, jmeta, np.asarray(scene.rgb), cloud


def test_detect_matches_reference(pipelines):
    jpipe, tpipe, jmeta, rgb, cloud = pipelines
    jd, js = jpipe.detect(rgb, cloud, threshold=85.0, return_stages=True)
    td, ts = tpipe.detect(rgb, cloud, threshold=85.0, return_stages=True)
    for name, a, b in zip(js.matches._fields, ts.matches, js.matches):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    for name in ("count", "bbox", "valid", "member_idx", "member_valid"):
        np.testing.assert_array_equal(getattr(ts.clusters, name).numpy(),
                                      np.asarray(getattr(js.clusters, name)), err_msg=name)
    np.testing.assert_array_equal(ts.nms_keep, js.nms_keep)
    np.testing.assert_array_equal(ts.cluster_order, js.cluster_order)
    np.testing.assert_array_equal(ts.poses.valid.numpy(), np.asarray(js.poses.valid))
    np.testing.assert_array_equal(ts.poses.rect.numpy(), np.asarray(js.poses.rect))
    assert len(td) == len(jd) >= 1
    for a, b in zip(td, jd):
        assert a.rect == b.rect
        assert abs(a.score - b.score) <= 1e-4
        deg, mm = _pose_err(a.pose, b.pose)
        assert deg <= DEG_TOL and mm <= MM_TOL, (deg, mm)
    # and the pose is right: the scene is training view 0 (canonicalized)
    R_gt = TC.canonicalize(t(jmeta.R[0]).float(), "x_front").numpy()
    gt = np.eye(4)
    gt[:3, :3], gt[:3, 3] = R_gt, jmeta.R[0] @ jmeta.T[0]
    deg, mm = _pose_err(td[0].pose, gt)
    assert deg < 5.0 and mm < 10.0, (deg, mm)


def test_detect_empty_scene(pipelines):
    jpipe, tpipe, *_ = pipelines
    rgb = np.zeros((H, W, 3), np.uint8)
    cloud = np.full((H, W, 3), np.nan, np.float32)
    assert tpipe.detect(rgb, cloud, threshold=85.0) == []
    assert jpipe.detect(rgb, cloud, threshold=85.0) == []


def _assert_stages_agree(ts, js):
    """StageOutputs of the port against the reference's: integer and
    boolean outputs equal, every valid lane's pose within the tolerance."""
    for name in ("count", "bbox", "valid", "member_idx", "member_valid"):
        np.testing.assert_array_equal(getattr(ts.clusters, name).numpy(),
                                      np.asarray(getattr(js.clusters, name)), err_msg=name)
    np.testing.assert_array_equal(ts.nms_keep, np.asarray(js.nms_keep))
    np.testing.assert_array_equal(ts.cluster_order, np.asarray(js.cluster_order))
    np.testing.assert_array_equal(ts.poses.valid.numpy(), np.asarray(js.poses.valid))
    np.testing.assert_array_equal(ts.poses.rect.numpy(), np.asarray(js.poses.rect))
    for lane in np.nonzero(np.asarray(js.poses.valid))[0]:
        for field in ("pose", "rough_pose"):
            deg, mm = _pose_err(getattr(ts.poses, field)[lane].numpy(),
                                np.asarray(getattr(js.poses, field)[lane]))
            assert deg <= DEG_TOL and mm <= MM_TOL, (field, lane, deg, mm)
        for field, tol in (("score", 1e-4), ("hyp_sim", 1e-4), ("hv_rate", 0.02),
                           ("icp_fitness", 1e-6)):
            assert abs(float(getattr(ts.poses, field)[lane])
                       - float(getattr(js.poses, field)[lane])) <= tol, field


# Combinations the golden does not hold: a refinement round with Kabsch
# ICP; the hole variant of distance_offset with the z_down
# canonicalization, the verification gate and two rounds; point-to-plane
# with one hypothesis, no sweep and a full-frame re-render.
EXTRA_OPTION_SETS = {
    "refine_two_stage": dict(refine_rounds=1),
    "hole_z_down_hv": dict(position_strategy="distance_offset", distance_offset_uses_hole=True,
                           canonicalize="z_down", enable_hv=True, refine_rounds=2),
    "plane_no_sweep": dict(icp_variant="point_to_plane", inplane_sweep=False,
                           render_viewport=0),
}


@pytest.mark.parametrize("config", list(TC.GOLDEN_OPTION_SETS) + list(EXTRA_OPTION_SETS))
def test_detect_options_match_reference(pipelines, config):
    """The whole detect in each non-default configuration of the golden,
    and in three further combinations, against the live reference
    pipeline: the accuracy configuration runs 2 x max_clusters slots x 2
    hypotheses = 8 lanes."""
    jpipe, tpipe, jmeta, rgb, cloud = pipelines
    options = EXTRA_OPTION_SETS.get(config) or TC.GOLDEN_OPTION_SETS[config][0]
    kw = dict(max_clusters=2, model_cap=512, scene_cap=512, icp_max_iter=40,
              cluster_filter_thresh=0, **options)
    jp = JPipe(jpipe.detector, jpipe.metadata, jpipe.globals, cuboid_mesh(),
               JC.CascadeParams(**kw), render_size=(W, H))
    tp = TPipe(tpipe.detector, tpipe.metadata, tpipe.globals, cuboid_mesh(),
               TC.CascadeParams(**kw), render_size=(W, H))
    jd, js = jp.detect(rgb, cloud, threshold=85.0, return_stages=True)
    td, ts = tp.detect(rgb, cloud, threshold=85.0, return_stages=True)
    _assert_stages_agree(ts, js)
    slots = 4 if kw.get("nms_after_pose") else 2
    assert ts.poses.valid.shape == (slots,) and ts.cluster_order.shape == (slots,)
    assert len(td) == len(jd) >= 1
    for a, b in zip(td, jd):
        assert a.rect == b.rect
    R_gt = TC.canonicalize(t(jmeta.R[0]).float(), kw.get("canonicalize", "x_front")).numpy()
    gt = np.eye(4)
    gt[:3, :3], gt[:3, 3] = R_gt, jmeta.R[0] @ jmeta.T[0]
    deg, mm = _pose_err(td[0].pose, gt)
    assert deg < 5.0 and mm < 10.0, (deg, mm)


def test_point_to_plane_without_normals_runs_two_stage(pipelines):
    """rough_pose_and_refine with icp_variant point_to_plane and no scene
    normals is the default two-stage run."""
    _, tpipe, _, rgb, cloud = pipelines
    want = tpipe.detect(rgb, cloud, threshold=85.0, return_stages=True)[1].poses
    params = dataclasses.replace(tpipe.params, icp_variant="point_to_plane")
    tp = TPipe(tpipe.detector, tpipe.metadata, tpipe.globals, cuboid_mesh(), params,
               render_size=(W, H))
    tp.scene_normals = lambda cloud: None
    got = tp.detect(rgb, cloud, threshold=85.0, return_stages=True)[1].poses
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# full width, against the committed golden
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_golden_cascade_on_cpu():
    """tools/make_torch_cascade_golden.py's frames through the port's CPU
    detect at full width: the real 2652-template RGB-D bank, the cuboid,
    default CascadeParams, threshold 91."""
    with np.load(GOLDEN) as z:
        g = {k: z[k] for k in z.files}
    pipe = TPipe.from_files(BANK, PARAMS, cuboid_mesh(), device="cpu")
    K = pipe.K_render
    for f in range(g["rgb"].shape[0]):
        cloud = TP.depth_to_cloud(TP.true_div(t(g["depth_mm"][f]), 1000.0), K)
        dets, st = pipe.detect(g["rgb"][f], cloud.numpy(), threshold=float(g["threshold"]),
                               depth_mm=g["depth_mm"][f], return_stages=True)
        for name, a in st.matches._asdict().items():
            np.testing.assert_array_equal(a.numpy(), g["m_" + name][f], err_msg=name)
        for name in ("count", "bbox", "valid", "member_idx", "member_valid"):
            np.testing.assert_array_equal(getattr(st.clusters, name).numpy(),
                                          g["c_" + name][f], err_msg=name)
        np.testing.assert_array_equal(st.poses.valid.numpy(), g["p_valid"][f])
        np.testing.assert_array_equal(st.poses.rect.numpy(), g["p_rect"][f])
        for lane in np.nonzero(g["p_valid"][f])[0]:
            deg, mm = _pose_err(st.poses.pose[lane].numpy(), g["p_pose"][f][lane])
            assert deg <= DEG_TOL and mm <= MM_TOL, (f, lane, deg, mm)
        assert (len(dets) >= 1) == (g["templates"][f] >= 0)


@pytest.mark.slow
@pytest.mark.parametrize("config", list(TC.GOLDEN_OPTION_SETS))
def test_golden_cascade_options_on_cpu(config):
    """tools/make_torch_cascade_golden.py's option sets through the port's
    CPU detect at full width, against
    tests/data/torch_cascade_options_golden.npz."""
    with np.load(GOLDEN) as z:
        frames = {k: z[k] for k in ("rgb", "depth_mm", "threshold")}
    with np.load(OPTIONS_GOLDEN) as z:
        g = {k[len(config) + 1:]: z[k] for k in z.files if k.startswith(config + "_")}
    options, frame_ids = TC.GOLDEN_OPTION_SETS[config]
    assert tuple(g["frames"]) == frame_ids
    pipe = TPipe.from_files(BANK, PARAMS, cuboid_mesh(), TC.CascadeParams(**options),
                            device="cpu")
    for i, f in enumerate(frame_ids):
        dep = frames["depth_mm"][f]
        cloud = TP.depth_to_cloud(TP.true_div(t(dep), 1000.0), pipe.K_render)
        _, st = pipe.detect(frames["rgb"][f], cloud, threshold=float(frames["threshold"]),
                            depth_mm=dep, return_stages=True)
        for name in ("count", "bbox", "valid", "member_idx", "member_valid"):
            np.testing.assert_array_equal(getattr(st.clusters, name).numpy(),
                                          g["c_" + name][i], err_msg=name)
        np.testing.assert_array_equal(st.nms_keep, g["nms_keep"][i])
        np.testing.assert_array_equal(st.cluster_order, g["cluster_order"][i])
        np.testing.assert_array_equal(st.poses.valid.numpy(), g["p_valid"][i])
        np.testing.assert_array_equal(st.poses.rect.numpy(), g["p_rect"][i])
        for lane in np.nonzero(g["p_valid"][i])[0]:
            deg, mm = _pose_err(st.poses.pose[lane].numpy(), g["p_pose"][i][lane])
            assert deg <= DEG_TOL and mm <= MM_TOL, (f, lane, deg, mm)
