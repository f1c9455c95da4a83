"""The eight-object LM-O cell (`lmo8-b32`, driver `harness/twoclass.py`,
plain reference `reference/multiclass.py`) on the CPU: its manifest
entries and the configuration keys the driver reads, its readers (a number
where the program has the span or counter, None for a program without
it), a whole small run that is correct, and a program that re-bases one
class's template ids wrongly, which turns `correct` false.

The small cell is the configuration as committed with its bank cut to a
slice that holds the seed's view: two frames, each planted with that view
eight times (later plants overlap earlier ones)."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import run as R
from benchmark.harness import scenes
from benchmark.harness.common import seeded_templates

from .test_bench_program_metrics import Ctx, trace

CELL = "lmo8-b32"
SEED = 3_000_000_001  # its view (template 12) matches the slice above 94 in both frames
METRICS = {"select_ms.lmo8", "pool_exact_ms.lmo8", "pool_bound_ms.lmo8", "fallback_ms.lmo8",
           "merge_ms.lmo8", "split_ms.lmo8", "walk_ms.lmo8", "pool_coarse_fill.lmo8",
           "pool_fine_fill.lmo8", "host_syncs_per_batch.lmo8", "device_idle_share.lmo8"}
# span readers -> the spans each reads
SPAN_READERS = {"select_ms.lmo8": ["lpe.pool.select"], "select_ms.twoobj": ["lpe.pool.select"],
                "pool_exact_ms.lmo8": ["lpe.pool.exact"],
                "pool_bound_ms.lmo8": ["lpe.pool.coarse", "lpe.pool.fine"],
                "fallback_ms.lmo8": ["lpe.pool.fallback"], "merge_ms.lmo8": ["lpe.merge"],
                "split_ms.lmo8": ["lpe.split"], "walk_ms.lmo8": ["lpe.walk"]}
COUNTER_READERS = {"pool_coarse_fill.lmo8": ("pool.coarse_total", "pool.coarse_slots"),
                   "pool_fine_fill.lmo8": ("pool.fine_total", "pool.fine_slots"),
                   "host_syncs_per_batch.lmo8": ("sync", "batch")}


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(R.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_the_cell_and_its_configuration(manifest):
    _, entry, config, traffic = R.load_cell(CELL)
    assert (entry["config"], entry["traffic"], entry["chips"]) == ("boxnew-rgbd-lmo8", CELL, 1)
    assert traffic == {"driver": "twoclass", "batch": 32, "pool": 96, "objects": 8,
                       "views": 16, "trace_steps": 30}
    # what the twoclass driver reads
    assert os.path.exists(os.path.join(R.BENCH, config["templates"]))
    assert os.path.exists(os.path.join(R.BENCH, config["params"]))
    assert len(config["classes"]) == len(set(config["classes"])) == 8
    assert config["classes"][0] == "obj"  # the bank file's own class id comes first
    assert config["thresholds"] == [92.0, 94.0] * 4
    mk = config["matcher"]
    assert (mk["prune_mode"], mk["top_k"], mk["fine_g"]) == ("pooled", 128, 4)
    for key in ("pool_coarse_per_frame", "pool_fine_per_frame", "sel_row_cap"):
        assert isinstance(mk[key], int) and mk[key] > 0
    assert (config["T"], config["features_per_modality"]) == ([5, 8], 63)
    conf = next(c for c in manifest["configs"] if c["name"] == "boxnew-rgbd-lmo8")
    assert conf["file"] == "benchmark/configs/boxnew-rgbd-lmo8.json"
    assert conf["reduced"] == ["banks", "mesh"]
    assert set(conf["reduced"]) <= set(config["source_values"])
    assert conf["source"] == config["source"]
    assert {m["name"] for m in R.metrics_of(manifest, CELL, "end_to_end")} == \
        {"frames_per_s", "setup_s"}
    assert {m["name"] for m in R.metrics_of(manifest, CELL, "per_layer")} == METRICS
    assert sum(w["chips"] == 4 for w in manifest["workloads"]) == 0


@pytest.mark.parametrize("metric", list(SPAN_READERS))
def test_span_readers(metric):
    spans = SPAN_READERS[metric]
    got = R.read_metric(metric, Ctx(trace("lpe.batch", spans + ["lpe.sync"])))
    assert got == pytest.approx(0.004 * len(spans) / 2)  # 4 us a span over 2 steps
    assert R.read_metric(metric, Ctx(trace(None, ["lpe.sync"]))) is None
    if metric.startswith("select_ms"):  # a program without the span: the parent's
        assert R.read_metric(metric, Ctx(trace("lpe.batch", ["lpe.pool.exact"]))) is None


@pytest.mark.parametrize("metric", list(COUNTER_READERS))
def test_counter_readers(metric, monkeypatch):
    from linemod_pose_estimation_tpu_torch.utils import tracing

    num, den = COUNTER_READERS[metric]
    ctx = Ctx(trace(None, []))
    monkeypatch.setattr(tracing, "counters", {num: 3, den: 4})
    assert R.read_metric(metric, ctx) == pytest.approx(0.75)
    # a program without the counters: the fine pool's are new
    others = {"pool.coarse_total": 3, "pool.coarse_slots": 4, "sync": 9, "batch": 1}
    monkeypatch.setattr(tracing, "counters", {k: v for k, v in others.items()
                                              if k not in (num, den)})
    assert R.read_metric(metric, ctx) is None


class _Window:
    def __init__(self, busy_s, window_s):
        self.busy_s, self.window_s = busy_s, window_s


def test_idle_reader():
    assert R.read_metric("device_idle_share.lmo8", Ctx(_Window(0.25, 1.0))) == \
        pytest.approx(0.75)
    assert R.read_metric("device_idle_share.lmo8", Ctx(_Window(0.0, 0.0))) is None


# ---------------------------------------------------------------------------
# A small run of the cell
# ---------------------------------------------------------------------------


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
    _, entry, config, _ = R.load_cell(CELL)
    traffic = {"driver": "twoclass", "batch": 2, "pool": 2, "objects": 8, "views": 1,
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


def test_a_small_run_is_correct(manifest, cell):
    res = execute(manifest, cell)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}
    assert res["checks"]["frames_wrong"]["value"] == 0
    assert res["checks"]["classes_unmatched"]["value"] == 0


def test_wrongly_rebased_ids_turn_correct_false(manifest, cell, monkeypatch):
    """One class's template ids re-based one column off (its split taking
    the previous class's lo + 1) is a wrong answer in every frame where
    that class matches."""
    from linemod_pose_estimation_tpu_torch.models.serving import MultiClassBatchedMatcher

    orig = MultiClassBatchedMatcher.match_batch

    def match_batch(self, rgbs, depths_mm=None):
        out = orig(self, rgbs, depths_mm)
        cid = self.class_ids[5]
        m = out[cid]
        out[cid] = m._replace(template_id=m.template_id + 1)
        return out

    monkeypatch.setattr(MultiClassBatchedMatcher, "match_batch", match_batch)
    res = execute(manifest, cell)
    assert not res["correct"] and res["failed"] >= 1
    assert res["checks"]["frames_wrong"]["value"] > 0
