"""PyTorch port vs the JAX reference, on CPU: the host surface —
api/transforms.py, api/service.py, api/nodes.py, utils/visualization.py
and DetectionPipeline.draw_response.

Tolerances: the transform chain, the wire quaternion (computed in
float32, as the reference's goes through JAX with 64-bit floats off),
frame conditioning, the replay readers, the overlays, the PNG bytes and
draw_response are exact.  The service and the nodes on the 160x120
fixture of tests/test_torch_cascade.py at threshold 85: detection rects
equal; poses and base-frame transforms within the CPU detect tolerance of
0.25 degrees / 0.5 mm (as tests/test_torch_cascade.py states why); the
identity transform on a miss and on an unknown object id.
"""

import numpy as np
import pytest

import _xdist_threads  # noqa: F401  (PyTorch threads per xdist worker)

from linemod_pose_estimation_tpu.api import nodes as JN
from linemod_pose_estimation_tpu.api import service as JSV
from linemod_pose_estimation_tpu.api import transforms as JTR
from linemod_pose_estimation_tpu.utils import visualization as JV
from linemod_pose_estimation_tpu_torch.api import nodes as TN
from linemod_pose_estimation_tpu_torch.api import service as TSV
from linemod_pose_estimation_tpu_torch.api import transforms as TTR
from linemod_pose_estimation_tpu_torch.utils import visualization as TV
from test_torch_cascade import DEG_TOL, MM_TOL, _pose_err, meta, pipelines  # noqa: F401

THRESHOLD = 85.0
IDENTITY = ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 1.0))


def _rotations(n, seed=0):
    """Random rotations, plus the cases that pick each of Shepperd's four
    branches, a half-turn and the identity."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    Rs = [JTR.quat_to_mat_np(*v) for v in q]
    for v in ((1, 0, 0, 0), (0.1, 0.99, 0.05, 0.02), (0.1, 0.02, 0.99, 0.05),
              (0.1, 0.02, 0.05, 0.99), (0, 1, 0, 0), (0.701074, 2.999e-05, 0.00514592, 0.71307)):
        Rs.append(JTR.quat_to_mat_np(*v))
    return Rs


def test_mat_to_quat_float32_rounding_exact():
    for R in _rotations(200):
        got, want = TTR.mat_to_quat_np(R), JTR.mat_to_quat_np(R)
        assert got == want, (R, got, want)
        assert got[3] >= 0.0
        # a float32 result: the float64 matrix's own quaternion differs
        assert all(np.float32(v) == v for v in got)


def test_transform_chain_exact(rng):
    for R in _rotations(40, seed=1):
        np.testing.assert_array_equal(TTR.tool0_to_depth(), JTR.tool0_to_depth())
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        tx = rng.normal(size=3)
        np.testing.assert_array_equal(TTR.quat_to_mat_np(*q), JTR.quat_to_mat_np(*q))
        A = TTR.make_affine(*tx, *q)
        np.testing.assert_array_equal(A, JTR.make_affine(*tx, *q))
        P = np.eye(4, dtype=np.float32)
        P[:3, :3], P[:3, 3] = R, rng.normal(size=3)
        np.testing.assert_array_equal(TTR.base_to_object(A, P), JTR.base_to_object(A, P))
        got = TTR.affine_to_transform(TTR.base_to_object(A, P))
        want = JTR.affine_to_transform(JTR.base_to_object(A, P))
        assert (got.translation, got.rotation) == (want.translation, want.rotation)
    assert TTR.REFERENCE_HAND_EYE == JTR.REFERENCE_HAND_EYE
    assert TTR.Transform.identity() == TTR.Transform(*IDENTITY)


def test_hand_eye_constant():
    """The reference's hand-eye check (tests/test_service.py)."""
    he = TTR.tool0_to_depth()
    np.testing.assert_allclose(he[:3, 3], [0.0672827, -0.0546864, 0.0466534])
    R = he[:3, :3]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-6)
    ang = np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))
    assert 89.0 < ang < 92.0


@pytest.mark.parametrize("mono, blur, bias_x", [(True, False, 56), (True, True, 56),
                                                (False, True, 0), (False, True, 17)])
def test_condition_frame_exact(mono, blur, bias_x):
    rng = np.random.default_rng(3)
    shape = (48, 80) if mono else (48, 80, 3)
    rgb = rng.integers(0, 256, shape, dtype=np.uint8)
    rgb[..., 0, :] = 255  # edge rows that wrap into the blur
    cloud = rng.normal(size=(48, 80, 3)).astype(np.float32)
    kw = dict(bias_x=bias_x, crop_w=40, crop_h=30, blur=blur)
    got = TSV.condition_frame(TSV.Frame(rgb, cloud), **kw)
    want = JSV.condition_frame(JSV.Frame(rgb, cloud), **kw)
    assert got.rgb.dtype == want.rgb.dtype == np.uint8
    np.testing.assert_array_equal(got.rgb, want.rgb)
    assert got.cloud is cloud


def test_replay_and_pcd_readers(tmp_path, rng):
    rgb = rng.integers(0, 255, (24, 32, 3), dtype=np.uint8)
    cloud = rng.normal(size=(24, 32, 3)).astype(np.float32)
    TN.save_replay_frame(str(tmp_path / "f0.npz"), rgb, cloud)
    TN.save_replay_frame(str(tmp_path / "f1.npz"), rgb + 1, cloud)
    port, ref = TN.ReplayFrameSource(str(tmp_path)), JN.ReplayFrameSource(str(tmp_path))
    for _ in range(3):  # wraps around
        a, b = port(), ref()
        np.testing.assert_array_equal(a.rgb, b.rgb)
        np.testing.assert_array_equal(a.cloud, b.cloud)
    one = TN.ReplayFrameSource(str(tmp_path / "f1.npz"))
    np.testing.assert_array_equal(one().rgb, rgb + 1)
    with pytest.raises(FileNotFoundError):
        TN.ReplayFrameSource(str(tmp_path / "empty_dir_missing"))
    p = tmp_path / "c.pcd"
    p.write_text(
        "# .PCD v0.7\nVERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
        "COUNT 1 1 1\nWIDTH 2\nHEIGHT 2\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS 4\n"
        "DATA ascii\n0.1 0.2 0.5\n0.2 0.2 0.5\nnan nan nan\n0.2 0.3 0.5\n")
    for kw in ({}, dict(width=4, height=1), dict(width=3, height=1)):
        a, b = TN.load_pcd_ascii(str(p), **kw), JN.load_pcd_ascii(str(p), **kw)
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert TN.load_pcd_ascii(str(p)).shape == (2, 2, 3)


def test_png_and_overlays_exact(tmp_path, rng):
    img = rng.integers(0, 255, (32, 48, 3), dtype=np.uint8)
    for rect in ((5, 5, 20, 15), (-3, 20, 60, 30), (40, -2, 10, 5)):
        np.testing.assert_array_equal(TV.draw_rect(img, rect, (255, 0, 0), 3),
                                      JV.draw_rect(img, rect, (255, 0, 0), 3))
    feats = np.array([[2, 3, 0], [8, 9, 4], [0, 0, 1], [40, 60, 2]], np.int32)
    np.testing.assert_array_equal(TV.draw_features(img, feats, (5, 5)),
                                  JV.draw_features(img, feats, (5, 5)))
    for arr in (img, img[..., 0], np.concatenate([img, img[..., :1]], -1)):
        TV.write_png(str(tmp_path / "a.png"), arr)
        JV.write_png(str(tmp_path / "b.png"), arr)
        assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()


def test_stage_timer(capsys):
    t = TV.StageTimer(verbose=True)
    with t.stage("match"):
        sum(range(1000))
    with t.stage("match"):
        pass
    with t.stage("icp"):
        pass
    assert list(t.times) == ["match", "icp"] and t.times["match"] > 0
    assert "match" in t.report() and "icp" in t.report()
    assert capsys.readouterr().out.count("Time consumed by") == 3


def test_draw_response_exact(pipelines):  # noqa: F811
    jpipe, tpipe, _, rgb, cloud = pipelines
    _, js = jpipe.detect(rgb, cloud, threshold=THRESHOLD, return_stages=True)
    _, ts = tpipe.detect(rgb, cloud, threshold=THRESHOLD, return_stages=True)
    for max_draw in (8, 2):
        want = jpipe.draw_response(rgb, js.matches, max_draw=max_draw)
        got = tpipe.draw_response(rgb, ts.matches, max_draw=max_draw)
        np.testing.assert_array_equal(got, want)
        assert (got != rgb).any()


def _frames(rgb, cloud):
    H, W = rgb.shape[:2]
    empty = (np.zeros((H, W, 3), np.uint8), np.full((H, W, 3), np.nan, np.float32))
    return [(rgb, cloud), empty, (rgb, cloud)]


def _transform_err(a, b):
    Ta = TTR.make_affine(*a.translation, a.rotation[3], *a.rotation[:3])
    Tb = TTR.make_affine(*b.translation, b.rotation[3], *b.rotation[:3])
    return _pose_err(Ta, Tb)


def test_pose_service_against_reference(pipelines):  # noqa: F811
    jpipe, tpipe, _, rgb, cloud = pipelines
    base_tool0 = TTR.make_affine(0.4, -0.2, 0.9, 0.8, 0.2, -0.1, 0.55)
    seq = _frames(rgb, cloud)
    services = []
    for mod, pipe in ((TSV, tpipe), (JSV, jpipe)):
        frames = iter(mod.Frame(*f) for f in seq)
        svc = mod.PoseService(lambda fr=frames: next(fr), base_tool0_source=lambda: base_tool0)
        svc.register_object(0, mod.ObjectConfig(pipeline=pipe, threshold=THRESHOLD))
        services.append(svc)
    for f in range(len(seq)):
        got, want = (s.linemod_object_pose(0) for s in services)
        if f == 1:  # the empty frame: a miss
            assert (got.translation, got.rotation) == IDENTITY == (want.translation,
                                                                  want.rotation)
            continue
        assert (got.translation, got.rotation) != IDENTITY
        deg, mm = _transform_err(got, want)
        assert deg <= DEG_TOL and mm <= MM_TOL, (f, deg, mm)
    for s in services:
        t = s.linemod_object_pose(42)
        assert (t.translation, t.rotation) == IDENTITY
    # the registry's detections themselves: rects equal
    a = tpipe.detect(rgb, cloud, THRESHOLD)
    b = jpipe.detect(rgb, cloud, THRESHOLD)
    assert [d.rect for d in a] == [d.rect for d in b]


def test_nodes_against_reference(pipelines):  # noqa: F811
    jpipe, tpipe, _, rgb, cloud = pipelines
    seq = _frames(rgb, cloud)
    published = {"port": [], "ref": []}
    runs = {}
    for key, mod, nodes, pipe in (("port", TSV, TN, tpipe), ("ref", JSV, JN, jpipe)):
        stream = nodes.StreamingDetector(pipe, threshold=THRESHOLD,
                                         on_pose=published[key].append)
        best = [stream.feed(mod.Frame(*f)) for f in seq]
        frames = iter(mod.Frame(*f) for f in seq + seq)
        poll = nodes.PollingMultiObjectDetector(lambda fr=frames: next(fr))
        assert poll.run_once() == (-1, [])
        poll.register_object(3, mod.ObjectConfig(pipeline=pipe, threshold=THRESHOLD))
        poll.register_object(1, mod.ObjectConfig(pipeline=pipe, threshold=99.9))
        runs[key] = (best, [poll.run_once() for _ in range(4)], stream.timer)
    (pb, pr, timer), (jb, jr, _) = runs["port"], runs["ref"]
    assert [b is None for b in pb] == [b is None for b in jb] == [False, True, False]
    assert len(published["port"]) == len(published["ref"]) == 2
    for a, b in zip(pb, jb):
        if a is not None:
            assert a.rect == b.rect
            deg, mm = _pose_err(a.pose, b.pose)
            assert deg <= DEG_TOL and mm <= MM_TOL, (deg, mm)
    assert [oid for oid, _ in pr] == [oid for oid, _ in jr] == [1, 3, 1, 3]
    for (_, da), (_, db) in zip(pr, jr):
        assert [d.rect for d in da] == [d.rect for d in db]
        for a, b in zip(da, db):
            deg, mm = _pose_err(a.pose, b.pose)
            assert deg <= DEG_TOL and mm <= MM_TOL, (deg, mm)
    assert "detect_total" in timer.times
