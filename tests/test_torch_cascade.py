"""PyTorch port vs the JAX reference: the detection cascade
(models/cascade.py) and DetectionPipeline.detect (models/pipeline.py),
on CPU.

The stages run on seeded inputs; the whole detect runs at 160x120 with
the focal lengths / 4 (as tests/test_cascade.py does) on a bank the
reference trains from renders of the cuboid stand-in for the boxNew mesh,
carried across with ``convert.py``.  The slow test holds the port's CPU
detect against ``tests/data/torch_cascade_golden.npz`` at full width.

Tolerances: matches, vote cells, member lists, NMS, cluster order,
detection validity and rects are equal; scores within 1e-4; poses within
0.25 degrees and 0.5 mm (ICP iterates to convergence from identical
clouds, but the reference's CPU XLA sums and fuses in its own order, so
nearest-neighbour ties and the convergence step can differ: measured
0.00-0.08 degrees and < 0.04 mm on the full-width frames).
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
])
def test_non_default_options_raise(meta, option):
    m, glob = meta
    params = TC.CascadeParams(**option)
    det = convert.detector_from_reference(JBank("box", JParams(), []), device="cpu")
    name = next(iter(option))
    with pytest.raises(NotImplementedError, match=name):
        TPipe(det, convert.metadata_from_reference(m), convert.globals_from_reference(glob),
              cuboid_mesh(), params)


def test_cascade_params_defaults_match_reference():
    assert dataclasses.asdict(TC.CascadeParams()) == dataclasses.asdict(JC.CascadeParams())


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
