"""Whole runs of small cells on the CPU (the harness's look for a chip
skipped), sound and with the timed path broken underneath: each fault
that a cell can have turns `correct` false."""

import numpy as np
import pytest
import torch

from benchmark import run as R

from .conftest import PARAMS, SEED


def execute(manifest, cell, config, traffic):
    return R.execute(manifest, cell, config, traffic, SEED, 0.2, 0, torch.device("cpu"))


def test_batch_sound(manifest, batch_cell):
    res = execute(manifest, *batch_cell)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}
    assert list(res)[-1] == "checks"


def _broken_batch(fault):
    from linemod_pose_estimation_tpu_torch.models.serving import BatchedMatcher

    orig = BatchedMatcher.match_batch

    def match_batch(self, rgbs, depths_mm=None):
        m = orig(self, rgbs, depths_mm)
        if fault == "half_batch":  # the second half of the batch left out
            valid = m.valid.clone()
            valid[valid.shape[0] // 2:] = False
            return m._replace(valid=valid)
        x = m.x.clone()  # an answer altered where it is produced
        x[m.valid] += 1
        return m._replace(x=x)

    return match_batch


@pytest.mark.parametrize("fault", ["half_batch", "altered_answer"])
def test_batch_fault(manifest, batch_cell, monkeypatch, fault):
    from linemod_pose_estimation_tpu_torch.models.serving import BatchedMatcher

    monkeypatch.setattr(BatchedMatcher, "match_batch", _broken_batch(fault))
    res = execute(manifest, *batch_cell)
    assert not res["correct"] and res["failed"] >= 1
    assert res["checks"]["frames_wrong"]["value"] > 0


@pytest.fixture(scope="module")
def detect_manifest(manifest):
    """The detect cell's end-to-end metrics (the cell is not in
    BENCHMARK.json: PERF.md, Open questions)."""
    extra = [{"name": n, "unit": "ms", "better": "lower", "bound": 0.25,
              "source": "host_clock", "workloads": ["detect-planted"]}
             for n in ("detect_ms_p50", "detect_ms_p95")]
    return {**manifest, "end_to_end": manifest["end_to_end"] + extra}


@pytest.fixture(scope="module")
def detect_cell():
    config = {"templates": "data/boxNew_rgbd_templates.yml.gz", "params": PARAMS}
    traffic = {"driver": "detect", "pool": 1, "objects": 1, "views": 1, "threshold": 91.0,
               "trace_steps": 1}
    return {"name": "detect-planted", "chips": 1}, config, traffic


@pytest.mark.parametrize("fault", [None, "altered_pose", "altered_matches"])
def test_detect(detect_manifest, detect_cell, monkeypatch, fault):
    from linemod_pose_estimation_tpu_torch.models.detector import Detector
    from linemod_pose_estimation_tpu_torch.models.pipeline import DetectionPipeline

    if fault == "altered_pose":  # a detection's pose moved by a millimetre
        orig = DetectionPipeline.detect

        def detect(self, *a, **k):
            dets = orig(self, *a, **k)
            for d in dets:
                d.pose = d.pose.copy()
                d.pose[0, 3] += 1e-3
            return dets

        monkeypatch.setattr(DetectionPipeline, "detect", detect)
    if fault == "altered_matches":  # the match stage reports one more pixel
        orig_m = Detector.match_raw

        def match_raw(self, *a, **k):
            out = orig_m(self, *a, **k)
            return {c: m._replace(y=m.y + 1) for c, m in out.items()}

        monkeypatch.setattr(Detector, "match_raw", match_raw)
    res = execute(detect_manifest, *detect_cell)
    if fault is None:
        assert res["correct"]
        assert set(res["metrics"]) == {"detect_ms_p50", "detect_ms_p95", "setup_s"}
    else:
        assert not res["correct"]


@pytest.fixture(scope="module")
def train_cell():
    config = {"templates": "data/boxNew_rgbd_templates.yml.gz", "params": PARAMS}
    traffic = {"driver": "train", "views": 24, "render_batch": 16, "width": 160,
               "height": 120, "check_views": 12, "trace_steps": 1}
    return {"name": "train-rgbd", "chips": 1}, config, traffic


@pytest.mark.parametrize("fault", [None, "state_unchanged", "altered_feature"])
def test_train(manifest, train_cell, monkeypatch, fault):
    from linemod_pose_estimation_tpu_torch.models import trainer
    from linemod_pose_estimation_tpu_torch.models.templates import TemplateBank

    orig = trainer.train_from_stl

    def train_from_stl(*a, **k):
        det, bank = orig(*a, **k)
        if fault == "state_unchanged":  # the call adds nothing to the empty bank
            bank = TemplateBank(bank.class_id, bank.params, [], metadata=bank.metadata)
            bank.metadata.R = bank.metadata.R[:0]
            bank.metadata.T = bank.metadata.T[:0]
        elif fault == "altered_feature":
            t = bank.templates[0]
            t.grad[0] = t.grad[0] + np.array([0, 1, 0], np.int32)
        return det, bank

    monkeypatch.setattr(trainer, "train_from_stl", train_from_stl)
    res = execute(manifest, *train_cell)
    assert res["correct"] == (fault is None)
    if fault:
        assert res["checks"]["views_wrong"]["value"] > 0
