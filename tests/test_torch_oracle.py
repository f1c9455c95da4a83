"""The PyTorch port against the GENUINE cv::linemod engine
(native/linemod_oracle.cpp over the system's libopencv_rgbd, through the
port's own bindings, utils/oracle.py): a second referee beside the JAX
reference.

- the quantizers, levels 0 and 1, colour and depth: bit-exact on the
  images tests/test_oracle_parity.py uses for the reference;
- the walk: score and position equal to cv::linemod's on a 5 x 5 grid of
  sub-T0 plants (px_delta exactly 0), through Detector.match and through
  BatchedMatcher in its exhaustive and `positions` modes;
- bank interchange: a bank written by the port loads in cv::linemod,
  feature for feature, and a bank cv::linemod wrote loads in the port by
  both read routes.

Tolerances are the reference tests' own: exact equality throughout.  The
tests skip where the oracle library cannot build (no OpenCV rgbd module).
"""

import numpy as np
import pytest
import torch

import _xdist_threads  # noqa: F401  (PyTorch threads per xdist worker)

from linemod_pose_estimation_tpu_torch.models.detector import Detector
from linemod_pose_estimation_tpu_torch.models.serving import BatchedMatcher
from linemod_pose_estimation_tpu_torch.models.templates import TemplateBank
from linemod_pose_estimation_tpu_torch.ops import features as F
from linemod_pose_estimation_tpu_torch.utils import native
from linemod_pose_estimation_tpu_torch.utils import oracle as ORC

H, W = 240, 320  # divisible by T0 = 5 and 2 * T1 = 16, as cv::linemod requires


@pytest.fixture(autouse=True)
def _needs_oracle():
    if not ORC.available():
        pytest.skip("cv::linemod oracle cannot build here (needs OpenCV's rgbd module)")


def textured_patch(rng, size=48):
    """A high-contrast blocky patch with strong gradients."""
    cells = rng.integers(30, 255, size=(size // 8, size // 8, 3), dtype=np.uint8)
    return np.repeat(np.repeat(cells, 8, 0), 8, 1)


def plant(patch, y, x):
    rgb = np.zeros((H, W, 3), np.uint8)
    mask = np.zeros((H, W), np.uint8)
    s = patch.shape[0]
    rgb[y:y + s, x:x + s] = patch
    mask[y:y + s, x:x + s] = 255
    return rgb, mask


def _color_images(rng):
    cells = rng.integers(0, 255, size=(30, 40, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:H, 0:W]
    return {
        "blocky": np.repeat(np.repeat(cells, 8, 0), 8, 1),
        "noise": rng.integers(0, 255, size=(H, W, 3), dtype=np.uint8),
        "smooth": np.stack([40 + 60 * yy / H + 30 * np.sin(xx / 20.0),
                            80 + 50 * np.cos(yy / 15.0),
                            120 + 40 * np.sin((xx + yy) / 25.0)], -1).astype(np.uint8),
    }


@pytest.mark.parametrize("image", ["blocky", "noise", "smooth"])
def test_quantization_vs_opencv_color_exact(rng, image):
    img = _color_images(rng)[image]
    q_cv = ORC.LinemodOracle().quantize(img)
    q = F.quantize_color_gradient(torch.from_numpy(img), 10.0)[0].numpy()
    assert (q_cv != 0).mean() > 0.05
    np.testing.assert_array_equal(q, q_cv)


def _depth_images(rng):
    ys, xs = np.mgrid[0:H, 0:W]
    holes = 800 + 2.0 * xs + 1.1 * ys
    holes[rng.random((H, W)) < 0.04] = 0
    return {
        "plane": 800 + 0.8 * xs + 1.3 * ys,
        "waves": 800 + 40 * np.sin(ys / 17) * np.cos(xs / 23),
        "dome": 900 - 0.002 * ((xs - 160) ** 2 + (ys - 120) ** 2),
        "steps": 700 + 90 * (xs // 13) + 2.7 * ys,
        "noisy": 1000 + 0.8 * xs + rng.integers(-3, 4, (H, W)),
        "holes": holes,
    }


@pytest.mark.parametrize("image", ["plane", "waves", "dome", "steps", "noisy", "holes"])
def test_quantization_vs_opencv_depth_exact(rng, image):
    depth = _depth_images(rng)[image].astype(np.uint16)
    q_cv = ORC.LinemodOracle(use_depth=True).quantize(None, modality=1, depth_mm=depth)
    q = F.quantize_depth_normal(torch.from_numpy(depth.astype(np.float32))).numpy()
    assert (q_cv != 0).any()
    assert int((q_cv != q).sum()) == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_quantization_vs_opencv_color_level1(seed):
    """cv::pyrDown's fixed-point u8 rounding is replicated, so the level-1
    quantization is bit-exact too."""
    rgb = np.random.default_rng(seed).integers(0, 255, (H, W, 3), dtype=np.uint8)
    q1_cv = ORC.LinemodOracle().quantize_level(rgb, modality=0, level=1)
    t = torch.from_numpy(rgb)
    rgb1 = torch.stack([F.pyr_down(t[..., c].to(torch.float32)) for c in range(3)], -1)
    q1 = F.quantize_color_gradient(rgb1, 10.0)[0].numpy()
    np.testing.assert_array_equal(q1, q1_cv)


def test_quantization_vs_opencv_depth_level1():
    """Level 1 of DepthNormal is a SUBSAMPLE of the level-0 quantized
    normals, which is what preprocess_frames_batched spreads."""
    ys, xs = np.mgrid[0:H, 0:W]
    dep = (900 + 50 * np.sin(ys / 13) * np.cos(xs / 19)).astype(np.uint16)
    q1_cv = ORC.LinemodOracle(use_depth=True).quantize_level(
        None, modality=1, depth_mm=dep, level=1)
    q0 = F.quantize_depth_normal(torch.from_numpy(dep.astype(np.float32))).numpy()
    np.testing.assert_array_equal(q0[::2, ::2], q1_cv)


@pytest.fixture
def bridge(tmp_path, rng):
    """One template trained by cv::linemod itself and read by the port
    through the yml bridge: (oracle, port detector, class id, patch)."""
    patch = textured_patch(rng)
    rgb, mask = plant(patch, 60, 100)
    o = ORC.LinemodOracle()
    assert o.add_template(rgb, mask)[0] == 0
    p = str(tmp_path / "bridge.yml")
    o.write(p)
    det = Detector.read(p, device="cpu")
    return o, det, det.class_ids[0], patch


def test_exact_position_parity_shift_grid(bridge):
    """px_delta is exactly 0, and the scores equal, over every phase of
    the T0 = 5 report grid."""
    o, det, cid, patch = bridge
    for dy in range(5):
        for dx in range(5):
            scene, _ = plant(patch, 60 + 7 + dy, 100 + 11 + dx)
            xyt, sim = o.match(scene, 85.0)
            ours = det.match(scene, 85.0)[cid]
            assert len(xyt) > 0 and len(ours) > 0, (dy, dx)
            ob, ub = int(np.argmax(sim)), int(np.argmax(ours.similarity))
            assert (int(xyt[ob][0]), int(xyt[ob][1])) == (
                int(ours.x[ub]), int(ours.y[ub])), (dy, dx)
            assert float(sim[ob]) == float(ours.similarity[ub]), (dy, dx)


@pytest.mark.parametrize("mode", ["exhaustive", "positions", "two_axis"])
def test_batched_matcher_walk_vs_opencv(bridge, mode):
    """The batched matcher's walk on a batch of shifted plants: each
    frame's best match is cv::linemod's, in score and position."""
    o, det, cid, patch = bridge
    shifts = [(0, 0), (3, 4), (17, 13), (-22, 38)]
    scenes = np.stack([plant(patch, 60 + sy, 100 + sx)[0] for sy, sx in shifts])
    kw = {} if mode == "exhaustive" else dict(prune=True, prune_mode=mode)
    m = BatchedMatcher(det, cid, 85.0, len(shifts), top_k=1, device="cpu", **kw
                       ).match_batch(scenes)
    for b, scene in enumerate(scenes):
        xyt, sim = o.match(scene, 85.0)
        ob = int(np.argmax(sim))
        assert bool(m.valid[b, 0])
        assert (int(m.x[b, 0]), int(m.y[b, 0])) == (int(xyt[ob][0]), int(xyt[ob][1]))
        assert float(m.similarity[b, 0]) == float(sim[ob])


def test_port_written_bank_loads_in_opencv(bridge, tmp_path):
    """Detector.write -> cv::linemod::Detector::read + readClass: the same
    features, template sizes and pyramid."""
    _, det, cid, _ = bridge
    p = str(tmp_path / "port.yml")
    det.write(p)
    o = ORC.LinemodOracle.read(p)
    assert o.num_templates == 1 and o.pyramid_levels == 2
    t = det.bank(cid).templates[0]
    for level in range(2):
        feats, (w_, h_) = o.template(0, level)
        assert (h_, w_) == tuple(t.size[level])
        # oracle rows are (x, y, label); the port holds (y, x, ori)
        assert sorted(map(tuple, feats.tolist())) == sorted(
            (int(f[1]), int(f[0]), int(f[2])) for f in t.grad[level])


@pytest.mark.parametrize("route", ["native", "yaml"])
def test_opencv_written_bank_loads_in_port(bridge, tmp_path, monkeypatch, route):
    o, _, _, _ = bridge
    p = str(tmp_path / "opencv.yml")
    o.write(p)
    if route == "yaml":
        monkeypatch.setattr(native, "available", lambda: False)
    bank = TemplateBank.read_templates_yaml(p, f_cap=64)
    assert len(bank.templates) == 1 and bank.params.t_pyramid == (5, 8)
    for level in range(2):
        feats, (w_, h_) = o.template(0, level)
        assert tuple(bank.templates[0].size[level]) == (h_, w_)
        assert sorted((int(f[1]), int(f[0]), int(f[2])) for f in feats) == sorted(
            map(tuple, np.asarray(bank.templates[0].grad[level]).tolist()))


def test_match_parity_own_extractions(rng):
    """tests/test_oracle_parity.py's own-extraction check on the port: each
    engine trains with its own feature extraction (the port's
    Detector.add_template, cv::linemod's addTemplate) on the same view, then
    matches the same shifted scene: both find it at >= 99 within the
    plateau distance (4 px) of each other."""
    patch = textured_patch(rng)
    rgb, mask = plant(patch, 60, 100)
    det = Detector(device="cpu")
    assert det.add_template(rgb, mask, "obj") == 0
    o = ORC.LinemodOracle()
    tid, _ = o.add_template(rgb, mask)
    assert tid == 0

    scene, _ = plant(patch, 88, 52)
    xyt, sim = o.match(scene, 85.0)
    ours = det.match(scene, 85.0)["obj"]
    assert len(xyt) > 0 and len(ours) > 0
    assert float(sim.max()) >= 99.0
    assert float(ours.similarity.max()) >= 99.0
    ob = int(np.argmax(sim))
    ub = int(np.argmax(ours.similarity))
    assert abs(int(xyt[ob][0]) - int(ours.x[ub])) <= 4
    assert abs(int(xyt[ob][1]) - int(ours.y[ub])) <= 4
