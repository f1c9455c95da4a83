"""The two-object cell (`twoobj-b32`, driver `harness/twoclass.py`, plain
reference `reference/multiclass.py`) on the CPU: the cell resolves by
name, a whole small run is correct, each fault that the merged matcher can
have turns `correct` false, and a class that no frame of the window
matches fails the run.

The small cell is the configuration as committed with its bank cut to a
slice that holds the seed's view: two frames, both planted with that view,
which matches at both thresholds (92 and 94)."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import run as R
from benchmark.harness import scenes, twoclass
from benchmark.harness.common import seeded_templates

from .test_bench_program_metrics import Ctx, trace

SEED = 3_000_000_001  # its view (template 12) matches the slice above 94 in both frames
METRICS = {"merge_ms.twoobj", "split_ms.twoobj", "pool_bound_ms.twoobj",
           "pool_exact_ms.twoobj", "fallback_ms.twoobj", "walk_ms.twoobj",
           "host_syncs_per_batch.twoobj", "pool_coarse_overflow_share.twoobj",
           "device_idle_share.twoobj"}


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(R.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    """The cell's entry, its configuration with the bank cut to a slice
    (every 83rd template and the seed's view), and a two-frame mix."""
    from linemod_pose_estimation_tpu_torch.models.detector import Detector
    from linemod_pose_estimation_tpu_torch.models.templates import TemplateBank

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    det = Detector.read(os.path.join(R.BENCH, "data/boxNew_rgbd_templates.yml.gz"),
                        device="cpu")
    bank = det.bank(det.class_ids[0])
    keep = sorted(set(seeded_templates(SEED, 2652, 1).tolist()) | set(range(0, 2652, 83)))
    path = str(tmp_path_factory.mktemp("bank") / "slice.yml")
    TemplateBank(bank.class_id, bank.params,
                 [bank.templates[i] for i in keep]).write_templates_yaml(path)
    _, entry, config, _ = R.load_cell("twoobj-b32")
    traffic = {"driver": "twoclass", "batch": 2, "pool": 2, "objects": 2, "views": 1,
               "trace_steps": 1}
    return entry, {**config, "templates": path}, traffic


_VIEWS: dict = {}


@pytest.fixture(autouse=True)
def rendered_once(monkeypatch):
    """Each run renders the same view (~10 s on the CPU): render it once."""
    render = scenes.render_views

    def cached(tris, Rs, Ts, *a, **k):
        key = (np.asarray(Rs).tobytes(), np.asarray(Ts).tobytes())
        if key not in _VIEWS:
            _VIEWS[key] = render(tris, Rs, Ts, *a, **k)
        return _VIEWS[key]

    monkeypatch.setattr(scenes, "render_views", cached)


def execute(manifest, cell):
    return R.execute(manifest, *cell, SEED, 0.2, 0, torch.device("cpu"))


def test_the_cell_resolves(manifest):
    _, entry, config, traffic = R.load_cell("twoobj-b32")
    assert (entry["config"], entry["chips"], traffic["driver"]) == ("boxnew-rgbd-2class", 1,
                                                                    "twoclass")
    assert config["thresholds"] == [92.0, 94.0] and len(config["classes"]) == 2
    assert os.path.exists(os.path.join(R.BENCH, config["templates"]))
    assert {m["name"] for m in R.metrics_of(manifest, "twoobj-b32", "end_to_end")} == \
        {"frames_per_s", "setup_s"}
    assert {m["name"] for m in R.metrics_of(manifest, "twoobj-b32", "per_layer")} == METRICS
    conf = next(c for c in manifest["configs"] if c["name"] == "boxnew-rgbd-2class")
    assert conf["reduced"] == ["banks", "mesh"]
    assert set(conf["reduced"]) <= set(config["source_values"])


def test_a_small_run_is_correct(manifest, cell):
    res = execute(manifest, cell)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}
    assert res["checks"]["frames_wrong"]["value"] == 0
    assert res["checks"]["classes_unmatched"]["value"] == 0


def _broken(fault):
    from linemod_pose_estimation_tpu_torch.models.serving import MultiClassBatchedMatcher

    orig = MultiClassBatchedMatcher.match_batch

    def match_batch(self, rgbs, depths_mm=None):
        out = orig(self, rgbs, depths_mm)
        first, second = self.class_ids
        if fault == "altered_x":  # one class's answers altered where they are made
            m = out[first]
            x = m.x.clone()
            x[m.valid] += 1
            out[first] = m._replace(x=x)
        else:  # one class's matches dropped
            m = out[second]
            out[second] = m._replace(valid=torch.zeros_like(m.valid))
        return out

    return match_batch


@pytest.mark.parametrize("fault", ["altered_x", "dropped_class"])
def test_a_fault_turns_correct_false(manifest, cell, monkeypatch, fault):
    from linemod_pose_estimation_tpu_torch.models.serving import MultiClassBatchedMatcher

    monkeypatch.setattr(MultiClassBatchedMatcher, "match_batch", _broken(fault))
    res = execute(manifest, cell)
    assert not res["correct"] and res["failed"] >= 1
    assert res["checks"]["frames_wrong"]["value"] > 0


def test_a_class_that_nothing_matches_fails_the_run(manifest, cell, monkeypatch):
    """Program and reference both find nothing of the second class: every
    frame agrees, and the run still fails on `classes_unmatched`."""
    from linemod_pose_estimation_tpu_torch.models.serving import MultiClassBatchedMatcher

    monkeypatch.setattr(MultiClassBatchedMatcher, "match_batch", _broken("dropped_class"))
    reference = twoclass.Cell.reference

    def blank_second(self, ids, lower=False):
        return {i: (w[0], []) for i, w in reference(self, ids, lower).items()}

    monkeypatch.setattr(twoclass.Cell, "reference", blank_second)
    res = execute(manifest, cell)
    assert res["checks"]["frames_wrong"]["value"] == 0
    assert res["checks"]["classes_unmatched"]["value"] == 1
    assert not res["correct"]


def test_compare_counts_frames_and_unmatched_classes():
    a, b = [(12, 300, 200, 7)], [(12, 301, 200, 7)]
    want = {0: (a, b), 1: (a, [])}
    got = twoclass.Cell.compare([(0, (a, b)), (1, (a, []))], want)
    assert {k: v["value"] for k, v in got.items()} == {"frames_wrong": 0, "classes_unmatched": 0}
    got = twoclass.Cell.compare([(0, (a, a)), (1, (a, []))], {0: (a, []), 1: (a, [])})
    assert {k: v["value"] for k, v in got.items()} == {"frames_wrong": 1, "classes_unmatched": 1}


@pytest.mark.parametrize("metric,span", [("merge_ms.twoobj", "lpe.merge"),
                                         ("split_ms.twoobj", "lpe.split")])
def test_merge_and_split_readers(metric, span):
    """A number where the program has the span; None for a program
    without it, even where the batch span is there."""
    got = R.read_metric(metric, Ctx(trace("lpe.batch", [span, "lpe.walk"])))
    assert got == pytest.approx(0.004 / 2)
    assert R.read_metric(metric, Ctx(trace("lpe.batch", ["lpe.walk"]))) is None
