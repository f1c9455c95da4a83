"""PyTorch port vs the JAX reference: the aux filters (ops/filters.py:
rgb_to_hsv_u8, hsv_color_filter, absolute_rectangle, nms_distance), on
CPU.

Inputs: the four filter cases of tests/test_filters_icp_schedule.py (each
through both packages), 200,000 seeded colours, seeded rects, ROIs and
vote cells, and tests/data/torch_aux_golden.npz (the cascade golden
frames and their detections; tools/make_torch_aux_golden.py).

Tolerance: every output equal, the HSV values bit for bit (the 1/255 is an
IEEE division and the hue's `% 6` a floor modulo in both packages).
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linemod_pose_estimation_tpu.ops import filters as JF
from linemod_pose_estimation_tpu_torch.ops import filters as TF

AUX_GOLDEN = "tests/data/torch_aux_golden.npz"
CASCADE_GOLDEN = "tests/data/torch_cascade_golden.npz"
GATE_RANGES = (((0.0, 180.0), (0.0, 255.0), (0.0, 255.0)),
               ((0.0, 30.0), (50.0, 255.0), (50.0, 255.0)),
               ((90.0, 150.0), (0.0, 255.0), (0.0, 255.0)),
               ((0.0, 180.0), (0.0, 20.0), (0.0, 222.0)))
NMS_SIZES = (1, 3)
t = lambda a: torch.from_numpy(np.array(a))
j = jnp.asarray


# -- the reference's four cases, through both packages -------------------------


def test_rgb_to_hsv_known_colors():
    rgb = np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255], [255, 255, 255]], np.uint8)
    got = TF.rgb_to_hsv_u8(t(rgb)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JF.rgb_to_hsv_u8(j(rgb))))
    np.testing.assert_allclose(got[:3], [[0, 255, 255], [60, 255, 255], [120, 255, 255]],
                               atol=1)
    np.testing.assert_allclose(got[3][1:], [0, 255], atol=1)


@pytest.mark.parametrize("ranges,want", [
    (((50, 70), (100, 255), (100, 255)), True),
    (((0, 20), (0.0, 255.0), (0.0, 255.0)), False),
])
def test_hsv_color_filter_gate(ranges, want):
    img = np.zeros((20, 20, 3), np.uint8)
    img[10, 10] = [0, 200, 0]  # green centre
    rect = np.array([5, 5, 10, 10])
    got = TF.hsv_color_filter(t(img), t(rect), *ranges)
    assert got.dtype == torch.bool and bool(got) == want
    assert bool(JF.hsv_color_filter(j(img), j(rect), *ranges)) == want


@pytest.mark.parametrize("roi,want", [([0, 0, 40, 30], [20, 10, 8, 5]),
                                      ([0, 0, 10, 10], [0, 0, 0, 0])])
def test_absolute_rectangle(roi, want):
    g = np.zeros((30, 40), np.float32)
    g[10:15, 20:28] = 200.0
    got = TF.absolute_rectangle(t(g), t(roi))
    assert got.dtype == torch.int32 and got.tolist() == want
    assert np.asarray(JF.absolute_rectangle(j(g), j(roi))).tolist() == want


def test_nms_distance():
    cells = np.array([[2, 2, 0], [3, 3, 0], [10, 10, 0]], np.int32)
    scores = np.array([95.0, 90.0, 80.0], np.float32)
    valid = np.ones(3, bool)
    got = TF.nms_distance(t(cells), t(scores), t(valid), neighbor_size=2)
    assert got.tolist() == [True, False, True]
    assert np.asarray(JF.nms_distance(j(cells), j(scores), j(valid), 2)).tolist() \
        == got.tolist()


# -- seeded inputs ------------------------------------------------------------


def test_rgb_to_hsv_seeded_colours_bitwise():
    rgb = np.random.default_rng(5).integers(0, 256, (200_000, 3)).astype(np.uint8)
    rgb[:6] = [[0, 0, 0], [255, 255, 255], [7, 7, 7], [255, 0, 1], [1, 0, 255], [0, 1, 0]]
    got = TF.rgb_to_hsv_u8(t(rgb)).numpy()
    want = np.asarray(JF.rgb_to_hsv_u8(j(rgb)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_nms_distance_chain_and_ties():
    """A beats B, B would beat C, C is far from A: a suppressed cell
    suppresses nothing, so C stays.  Equal scores keep the lower index
    first (the stable order); invalid cells suppress nothing and stay
    dropped."""
    cells = np.array([[0, 0, 0], [2, 0, 1], [4, 0, 2], [20, 20, 0], [21, 20, 0],
                      [40, 40, 0], [41, 41, 0]], np.int32)
    scores = np.array([90.0, 85.0, 80.0, 70.0, 70.0, 99.0, 50.0], np.float32)
    valid = np.array([1, 1, 1, 1, 1, 0, 1], bool)
    got = TF.nms_distance(t(cells), t(scores), t(valid), 2)
    want = np.asarray(JF.nms_distance(j(cells), j(scores), j(valid), 2))
    assert got.tolist() == want.tolist() == [True, False, True, True, False, False, True]


@pytest.mark.parametrize("seed", [0, 1])
def test_filters_seeded(seed):
    """Random rects (partly off the frame) and ROIs, and 300 cells with
    tied scores at three neighbour sizes."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (60, 80, 3)).astype(np.uint8)
    gray = img[..., 0].astype(np.float32)
    for _ in range(20):
        r = np.concatenate([rng.integers(-10, [80, 60]), rng.integers(1, 50, 2)])
        for ranges in GATE_RANGES:
            assert bool(TF.hsv_color_filter(t(img), t(r), *ranges)) == \
                bool(JF.hsv_color_filter(j(img), j(r), *ranges))
        assert TF.absolute_rectangle(t(gray), t(r), 240.0).tolist() == \
            np.asarray(JF.absolute_rectangle(j(gray), j(r), 240.0)).tolist()
    cells = rng.integers(0, 30, (300, 3)).astype(np.int32)
    scores = (80 + rng.integers(0, 10, 300)).astype(np.float32)
    valid = rng.random(300) < 0.8
    for size in (0, 1, 3):
        got = TF.nms_distance(t(cells), t(scores), t(valid), size)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(JF.nms_distance(j(cells), j(scores), j(valid), size)))


# -- the golden -----------------------------------------------------------------


@pytest.fixture(scope="module")
def golden():
    with np.load(AUX_GOLDEN) as z:
        a = {k: z[k] for k in z.files}
    with np.load(CASCADE_GOLDEN) as z:
        g = {k: z[k] for k in z.files}
    noise = np.random.default_rng(13).integers(0, 256, (480, 640, 3)).astype(np.uint8)
    return a, g, noise


def test_golden_hsv(golden):
    a, g, noise = golden
    for f, rgb in enumerate(list(g["rgb"]) + [noise]):
        h = TF.rgb_to_hsv_u8(t(rgb)).numpy()
        want = a["hsv_sha256"][f] if f < 4 else a["hsv_noise_sha256"]
        sample = a["hsv_sample"][f] if f < 4 else a["hsv_noise_sample"]
        np.testing.assert_array_equal(h[::16, ::16], sample)
        assert hashlib.sha256(h.tobytes()).digest() == want.tobytes(), f


def test_golden_gate_absrect_nms(golden):
    a, g, noise = golden
    imgs = [t(f) for f in g["rgb"]] + [t(noise)]
    gate = [[bool(TF.hsv_color_filter(imgs[f], t(r), *ranges)) for ranges in GATE_RANGES]
            for f, r in zip(a["gate_frame"], a["gate_rects"])]
    np.testing.assert_array_equal(gate, a["gate"])
    full = [0, 0, 640, 480]
    rects = [[TF.absolute_rectangle(t(1500.0 - g["depth_mm"][f]), t(roi), 10.0).tolist()
              for roi in (g["p_rect"][f, 0], full)] for f in range(4)]
    np.testing.assert_array_equal(rects, a["absrect"])
    green = t(noise[..., 1].astype(np.float32))
    np.testing.assert_array_equal(
        [TF.absolute_rectangle(green, t(r), 250.0).tolist() for r in a["gate_rects"][-64:]],
        a["absrect_noise"])
    for f in range(4):
        cells = np.stack([g["m_y"][f] // 8, g["m_x"][f] // 8, g["m_template_id"][f] % 4], -1)
        for i, s in enumerate(NMS_SIZES):
            keep = TF.nms_distance(t(cells.astype(np.int32)), t(g["m_similarity"][f]),
                                   t(g["m_valid"][f]), s)
            np.testing.assert_array_equal(keep.numpy(), a["nms_keep"][f, i])
    for i, s in enumerate(NMS_SIZES):
        keep = TF.nms_distance(t(a["nms_cells"]), t(a["nms_scores"]), t(a["nms_valid"]), s)
        np.testing.assert_array_equal(keep.numpy(), a["nms_noise_keep"][i])
