"""The Ensenso entry of the batched matcher on the CPU: raw mono (or
three-channel) camera frames conditioned on the device
(``ops/features.py::condition_frames``) bit for bit as the pose service's
``api/service.py::condition_frame`` conditions each frame, and a
BatchedMatcher with a FrameConditioning equal to the same matcher on frames
conditioned on the host; slice_settings' pools.

The matcher runs on 240x320 crops of the committed scenes, turned mono and
widened to 376 columns, with the 64-template subset of the committed
colour-only bank (its templates do not fit smaller frames)."""

import numpy as np
import pytest
import torch

import _xdist_threads  # noqa: F401  (PyTorch threads per xdist worker)

from linemod_pose_estimation_tpu_torch.api import service as SV
from linemod_pose_estimation_tpu_torch.models import serving
from linemod_pose_estimation_tpu_torch.models.detector import Detector
from linemod_pose_estimation_tpu_torch.models.serving import BatchedMatcher
from linemod_pose_estimation_tpu_torch.models.templates import TemplateBank
from linemod_pose_estimation_tpu_torch.ops import features as TF
from linemod_pose_estimation_tpu_torch.utils import scenes as S

RGB_BANK = "data/boxNew_full_templates.yml.gz"
RGBD_BANK = "data/boxNew_rgbd_templates.yml.gz"


def mono(rgbs: np.ndarray) -> np.ndarray:
    c = rgbs.astype(np.int32)
    return ((4899 * c[..., 0] + 9617 * c[..., 1] + 1868 * c[..., 2] + 8192) >> 14
            ).astype(np.uint8)


def host_conditioned(frames: np.ndarray, **kw) -> np.ndarray:
    """condition_frame of each frame, as (n, h, w, 3) u8."""
    return np.stack([SV.condition_frame(SV.Frame(f, None), **kw).rgb for f in frames])


# (frame shape, conditioning): the camera's 752x480 at the service's
# defaults; odd sizes with other offsets, a crop as tall as the frame (rows
# 0 and H-1 wrap into each other) and one shorter, and the blur off.
CASES = [
    ((2, 480, 752), {}),
    ((2, 480, 752, 3), {}),
    ((3, 37, 61), dict(bias_x=0, crop_w=61, crop_h=37)),
    ((3, 37, 61, 3), dict(bias_x=5, crop_w=50, crop_h=30)),
    ((2, 37, 61), dict(bias_x=11, crop_w=50, crop_h=37, blur=False)),
    ((2, 37, 61, 3), dict(bias_x=3, crop_w=58, crop_h=36, blur=False)),
]


@pytest.mark.parametrize("shape,kw", CASES, ids=[f"{len(s) - 3}ch{s[1]}x{s[2]}-{i}"
                                                  for i, (s, _) in enumerate(CASES)])
def test_condition_frames_equals_condition_frame(shape, kw):
    rng = np.random.default_rng(len(shape) * 100 + shape[1])
    frames = rng.integers(0, 256, shape, dtype=np.uint8)
    frames[:, 0] = 255  # edge rows and columns that wrap into the blur
    frames[:, :, -1] = 0
    got = TF.condition_frames(torch.from_numpy(frames), **kw)
    want = host_conditioned(frames, **kw)
    assert got.dtype == torch.uint8 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


def test_condition_frames_refuses_what_does_not_fit():
    frames = torch.zeros((2, 480, 752), dtype=torch.uint8)
    with pytest.raises(ValueError, match="does not fit"):
        TF.condition_frames(frames, bias_x=113)
    with pytest.raises(ValueError, match="uint8"):
        TF.condition_frames(frames.float())
    with pytest.raises(ValueError, match="uint8"):
        TF.condition_frames(torch.zeros((2, 480, 752, 4), dtype=torch.uint8))


@pytest.fixture(scope="module")
def rgb_sub():
    det = Detector.read(RGB_BANK, device="cpu")
    cid = det.class_ids[0]
    bank = det.bank(cid)
    sub = Detector(bank.params, device="cpu")
    sub.attach_bank(TemplateBank(cid, bank.params,
                                 [bank.templates[i] for i in S.CROP_BANK_SUBSET]))
    return sub, cid


@pytest.fixture(scope="module")
def wide_frames():
    """The two 240x320 crops in mono, widened to 376 columns of noise on
    either side (bias_x 28)."""
    rgbs, _ = S.golden_crops()
    rng = np.random.default_rng(5)
    wide = rng.integers(0, 256, (2, 240, 376), dtype=np.uint8)
    wide[:, :, 28:348] = mono(rgbs)
    return wide


COND = SV.FrameConditioning(bias_x=28, crop_w=320, crop_h=240)


@pytest.mark.parametrize("channels", [1, 3])
def test_conditioned_matcher_equals_host_conditioned_frames(rgb_sub, wide_frames, channels):
    sub, cid = rgb_sub
    frames = wide_frames if channels == 1 else np.repeat(wide_frames[..., None], 3, -1)
    kw = dict(top_k=64, prune=True, prune_mode="pooled", device="cpu", plain=True)
    got = BatchedMatcher(sub, cid, 65.0, 2, conditioning=COND, **kw).match_batch(frames)
    host = host_conditioned(frames, bias_x=28, crop_w=320, crop_h=240)
    want = BatchedMatcher(sub, cid, 65.0, 2, **kw).match_batch(host)
    assert int(want.valid.sum()) > 0  # the crops' object matches
    for name, a, b in zip(got._fields, got, want):
        assert torch.equal(a, b), name


def test_conditioning_refuses_depth(rgb_sub, wide_frames):
    sub, cid = rgb_sub
    m = BatchedMatcher(sub, cid, 65.0, 2, device="cpu", conditioning=COND)
    with pytest.raises(ValueError, match="no depths_mm"):
        m.match_batch(wide_frames, np.zeros((2, 240, 376), np.float32))
    rgbd = Detector.read(RGBD_BANK, device="cpu")
    with pytest.raises(ValueError, match="DepthNormal"):
        BatchedMatcher(rgbd, rgbd.class_ids[0], 91.0, 2, device="cpu", conditioning=COND)


def test_slice_settings_pools():
    """Two modalities: the production dict as it was; one: the sized pools."""
    for B in (1, 8, 32):
        want = dict(top_k=128, prune=True, prune_mode="pooled", fine_g=4,
                    pool_coarse=56 * B, pool_fine=36 * B, sel_row_cap=128,
                    group_bound=16, pool_group=B * 1200)
        assert serving.slice_settings(B) == want
        assert serving.slice_settings(B, modalities=2) == want
        coarse, fine = serving.POOLS_ONE_MODALITY
        assert serving.slice_settings(B, modalities=1) == {
            **want, "pool_coarse": coarse * B, "pool_fine": fine * B}
    assert serving.slice_settings(4, 240, 320)["pool_group"] == 4 * 300
