"""The port's entry points run on the card unless the caller asks for the
CPU: every public constructor and factory defaults to device="cuda", and
on a host without a card building one without `device=` raises (it never
falls back to the CPU).  On a host with a card the same calls land there.
"""

import inspect

import numpy as np
import pytest
import torch

from linemod_pose_estimation_tpu_torch import convert
from linemod_pose_estimation_tpu_torch.models.detector import Detector
from linemod_pose_estimation_tpu_torch.models.pipeline import DetectionPipeline
from linemod_pose_estimation_tpu_torch.models.renderer import Renderer
from linemod_pose_estimation_tpu_torch.models.serving import (
    BatchedMatcher, MultiClassBatchedMatcher)
from linemod_pose_estimation_tpu_torch.models.templates import DetectorParams, TemplateBank
from linemod_pose_estimation_tpu_torch.utils.device import resolve_device
from linemod_pose_estimation_tpu_torch.utils.scenes import cuboid_mesh

BANK = "data/boxNew_rgbd_templates.yml.gz"
PARAMS = "data/boxNew_rgbd_params.yml.gz"

ENTRY_POINTS = {
    "Detector": Detector,
    "Detector.read": Detector.read,
    "BatchedMatcher": BatchedMatcher,
    "MultiClassBatchedMatcher": MultiClassBatchedMatcher,
    "Renderer": Renderer,
    "DetectionPipeline.from_files": DetectionPipeline.from_files,
    "convert.level_features_from_numpy": convert.level_features_from_numpy,
    "convert.bank_from_numpy": convert.bank_from_numpy,
    "convert.detector_from_reference": convert.detector_from_reference,
    "convert.triangles_from_numpy": convert.triangles_from_numpy,
    "convert.matches_from_numpy": convert.matches_from_numpy,
    "convert.coarse_matches_from_numpy": convert.coarse_matches_from_numpy,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name):
    assert inspect.signature(ENTRY_POINTS[name]).parameters["device"].default == "cuda"


@pytest.fixture(scope="module")
def cpu_detector():
    return Detector.read(BANK, device="cpu")


def _builders(det):
    """Each entry point called without `device=`, on small inputs; each
    returns something that holds a device or a tensor."""
    cid = det.class_ids[0]
    bank = det.bank(cid)
    i32 = np.zeros((2, 3), np.int32)
    two = Detector(bank.params, device="cpu")
    two.attach_bank(bank)
    two.attach_bank(TemplateBank("second", bank.params, bank.templates))
    return {
        "Detector": lambda: Detector(DetectorParams()),
        "Detector.read": lambda: Detector.read(BANK),
        "BatchedMatcher": lambda: BatchedMatcher(det, cid, 91.0, 2),
        "MultiClassBatchedMatcher": lambda: MultiClassBatchedMatcher(
            two, [cid, "second"], 91.0, 2, prune_mode="pooled"),
        "Renderer": lambda: Renderer(cuboid_mesh(subdiv=2), 64, 48, 60.0, 60.0),
        "DetectionPipeline.from_files": lambda: DetectionPipeline.from_files(
            BANK, PARAMS, cuboid_mesh()),
        "convert.level_features_from_numpy": lambda: convert.level_features_from_numpy(
            i32, i32, i32 > 0, i32[:, 0], i32),
        "convert.bank_from_numpy": lambda: convert.bank_from_numpy(
            np.zeros((8, 2), np.int8), np.zeros((2, 8), np.int8), np.zeros((2, 8), np.int8)),
        "convert.detector_from_reference": lambda: convert.detector_from_reference(bank),
        "convert.triangles_from_numpy": lambda: convert.triangles_from_numpy(
            np.zeros((2, 3, 3), np.float32)),
        "convert.matches_from_numpy": lambda: convert.matches_from_numpy(
            *([np.zeros(3)] * 5)),
        "convert.coarse_matches_from_numpy": lambda: convert.coarse_matches_from_numpy(
            *([np.zeros(3)] * 5)),
    }


def _device_of(obj) -> torch.device:
    """The device of an object's first tensor (its `device` if it has one)."""
    if isinstance(obj, torch.Tensor):
        return obj.device
    if hasattr(obj, "device"):
        return obj.device
    return _device_of(next(v for v in obj if isinstance(v, (torch.Tensor, tuple))))


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_without_device_is_on_the_card_or_raises(cpu_detector, name):
    build = _builders(cpu_detector)[name]
    if torch.cuda.is_available():
        assert _device_of(build()).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device("cuda:0")


@pytest.mark.parametrize("lost", [0, 1, 10])
def test_kernel_times_reads_the_mean_of_the_launches_a_trace_holds(monkeypatch, lost):
    """chip_smoke.kernel_times on traces that lost `lost` of a kernel's 20
    records: each kernel's time is its summed time over the launches the
    trace holds, so it reads the same as from a full trace, and the count is
    reported."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    taken = []

    def trace(fn, kernel, reps):
        taken.append(reps)
        return ({"a_kernel": 0.5 * (reps - lost), "b_kernel": 0.25 * 2 * reps},
                {"a_kernel": reps - lost, "b_kernel": 2 * reps})

    monkeypatch.setattr(chip_smoke, "trace_kernel", trace)
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, reps: 1.5)
    out = chip_smoke.kernel_times(lambda: None, "kernel", reps=20, per_call=3)
    assert out["ms"] == 0.5 + 2 * 0.25
    assert out["parts"] == {"a_kernel": 0.5, "b_kernel": 0.5}
    assert out["trace_launches"] == 60 - lost and out["trace_full"] == (lost == 0)
    assert out["traces"] == len(taken) == (1 if lost == 0 else 5)
    assert out["call_ms"] == 1.5
    monkeypatch.setattr(chip_smoke, "trace_kernel", lambda fn, kernel, reps: ({}, {}))
    with pytest.raises(AssertionError, match="holds 0 launches"):
        chip_smoke.kernel_times(lambda: None, "kernel")
    monkeypatch.setattr(chip_smoke, "trace_kernel",
                        lambda fn, kernel, reps: ({"a_kernel": 1.0}, {"a_kernel": reps + 1}))
    with pytest.raises(AssertionError, match="holds 21 launches"):
        chip_smoke.kernel_times(lambda: None, "kernel")
