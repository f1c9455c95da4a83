"""The Ensenso cell (`ensenso-rgb-b32`, driver `harness/ensenso.py`, plain
reference `reference/ensenso.py`) on the CPU: the cell resolves by name,
the reference's integer conditioning is the pose service's condition_frame
bit for bit, a whole small run is correct, a run whose timed path
conditions the frames wrongly (the blur off, or the conditioning skipped)
turns `correct` false, and a window the reference matches nothing in fails
the run.

The small cell is the configuration as committed with its colour-only bank
cut to a slice that holds the seed's view (tiled x2), two raw mono 752x480
frames a batch, each planted with that view twice."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import run as R
from benchmark.harness import ensenso, scenes
from benchmark.harness.common import seeded_templates
from benchmark.reference import ensenso as RE

from .test_bench_program_metrics import Ctx, trace

SEED = 3_000_000_001  # its view (template 12) matches the slice at 85 in both frames
METRICS = {"condition_ms.ensenso", "h2d_ms.ensenso", "preprocess_ms.ensenso",
           "pool_bound_ms.ensenso", "pool_exact_ms.ensenso", "fallback_ms.ensenso",
           "walk_ms.ensenso", "pool_coarse_fill.ensenso",
           "pool_coarse_overflow_share.ensenso", "host_syncs_per_batch.ensenso",
           "device_idle_share.ensenso"}


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(R.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    """The cell's entry, its configuration with the bank cut to a slice
    (every 83rd template and the seed's view, tiled x2), and a two-frame mix."""
    from linemod_pose_estimation_tpu_torch.models.detector import Detector
    from linemod_pose_estimation_tpu_torch.models.templates import TemplateBank

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    _, entry, config, traffic = R.load_cell("ensenso-rgb-b32")
    det = Detector.read(os.path.join(R.BENCH, config["templates"]), device="cpu")
    bank = det.bank(det.class_ids[0])
    keep = sorted(set(seeded_templates(SEED, 2652, 1).tolist()) | set(range(0, 2652, 83)))
    path = str(tmp_path_factory.mktemp("bank") / "slice.yml")
    TemplateBank(bank.class_id, bank.params,
                 [bank.templates[i] for i in keep]).write_templates_yaml(path)
    small = {**traffic, "batch": 2, "pool": 2, "views": 1, "trace_steps": 1}
    return entry, {**config, "templates": path, "tile": [2, 2 * len(keep) + 6]}, small


_VIEWS: dict = {}


@pytest.fixture(autouse=True)
def rendered_once(monkeypatch):
    """Each run renders the same 752x480 view (~10 s on the CPU): render it
    once."""
    render = scenes.render_views

    def cached(tris, Rs, Ts, *a, **k):
        key = (np.asarray(Rs).tobytes(), np.asarray(Ts).tobytes(), k.get("W"), k.get("H"))
        if key not in _VIEWS:
            _VIEWS[key] = render(tris, Rs, Ts, *a, **k)
        return _VIEWS[key]

    monkeypatch.setattr(scenes, "render_views", cached)


def execute(manifest, cell):
    return R.execute(manifest, *cell, SEED, 0.2, 0, torch.device("cpu"))


def test_the_cell_resolves(manifest):
    _, entry, config, traffic = R.load_cell("ensenso-rgb-b32")
    assert (entry["config"], entry["chips"], traffic["driver"]) == ("boxnew-rgb-ensenso-x4", 1,
                                                                    "ensenso")
    assert config["modalities"] == ["ColorGradient"] and config["threshold"] == 85.0
    assert (config["frame_in"], config["bias_x"], config["crop"]) == ([752, 480], 56, [640, 480])
    assert (traffic["width"], traffic["height"], traffic["bias_x"]) == (752, 480, 56)
    assert os.path.exists(os.path.join(R.BENCH, config["templates"]))
    assert os.path.exists(os.path.join(R.BENCH, config["params"]))
    assert {m["name"] for m in R.metrics_of(manifest, "ensenso-rgb-b32", "end_to_end")} == \
        {"frames_per_s", "setup_s"}
    assert {m["name"] for m in R.metrics_of(manifest, "ensenso-rgb-b32", "per_layer")} == METRICS
    conf = next(c for c in manifest["configs"] if c["name"] == "boxnew-rgb-ensenso-x4")
    assert conf["reduced"] == ["num_templates", "mesh", "threshold"]
    assert set(conf["reduced"]) <= set(config["source_values"])


@pytest.mark.parametrize("shape,kw", [
    ((2, 480, 752), dict(bias_x=56, crop_w=640, crop_h=480)),
    ((2, 480, 752, 3), dict(bias_x=56, crop_w=640, crop_h=480)),
    ((3, 37, 61), dict(bias_x=0, crop_w=61, crop_h=37)),
    ((3, 37, 61, 3), dict(bias_x=5, crop_w=50, crop_h=30)),
    ((2, 37, 61), dict(bias_x=11, crop_w=50, crop_h=37, blur=False)),
])
def test_the_reference_conditions_as_the_service_does(shape, kw):
    """The integer conditioning against the port's host condition_frame,
    frame by frame, the wrap at rows 0 and H-1 included."""
    from linemod_pose_estimation_tpu_torch.api.service import Frame, condition_frame

    rng = np.random.default_rng(shape[1])
    frames = rng.integers(0, 256, shape, dtype=np.uint8)
    frames[:, 0] = 255
    got = RE.condition(frames, **{"blur": True, **kw})
    for f, g in zip(frames, got):
        np.testing.assert_array_equal(g, condition_frame(Frame(f, None), **kw).rgb)


def test_mono_is_bt601_in_integers():
    rgb = np.array([[[[255, 255, 255], [0, 0, 0], [255, 0, 0], [0, 255, 0], [0, 0, 255],
                      [10, 200, 30]]]], np.uint8)
    assert ensenso.to_mono(rgb).tolist() == [[[255, 0, 76, 150, 29, 124]]]


def test_a_small_run_is_correct(manifest, cell):
    res = execute(manifest, cell)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}
    assert res["checks"]["frames_wrong"]["value"] == 0
    assert res["checks"]["window_unmatched"]["value"] == 0


def _broken(fault):
    from linemod_pose_estimation_tpu_torch.ops.features import condition_frames

    def broken(frames, bias_x, crop_w, crop_h, blur):
        if fault == "blur_off":
            return condition_frames(frames, bias_x, crop_w, crop_h, False)
        # skipped: the frame's first crop_w columns as they came
        return condition_frames(frames, 0, crop_w, crop_h, False)

    return broken


@pytest.mark.parametrize("fault", ["blur_off", "skipped"])
def test_a_wrong_conditioning_turns_correct_false(manifest, cell, monkeypatch, fault):
    from linemod_pose_estimation_tpu_torch.models import serving

    monkeypatch.setattr(serving, "condition_frames", _broken(fault))
    res = execute(manifest, cell)
    assert not res["correct"] and res["failed"] >= 1
    assert res["checks"]["frames_wrong"]["value"] > 0


def test_a_window_that_nothing_matches_fails_the_run(manifest, cell, monkeypatch):
    """Program and reference both find nothing: every frame agrees, and the
    run still fails on `window_unmatched`."""
    from linemod_pose_estimation_tpu_torch.models.serving import BatchedMatcher

    orig = BatchedMatcher.match_batch

    def nothing(self, rgbs, depths_mm=None):
        m = orig(self, rgbs, depths_mm)
        return m._replace(valid=torch.zeros_like(m.valid))

    monkeypatch.setattr(BatchedMatcher, "match_batch", nothing)
    monkeypatch.setattr(ensenso.Cell, "reference",
                        lambda self, ids, lower=False: {i: [] for i in ids})
    res = execute(manifest, cell)
    assert res["checks"]["frames_wrong"]["value"] == 0
    assert res["checks"]["window_unmatched"]["value"] == 1
    assert not res["correct"]


def test_compare_counts_frames_and_an_empty_window():
    a, b = [(12, 300, 200, 7)], [(12, 301, 200, 7)]
    got = ensenso.Cell.compare([(0, a), (1, [])], {0: a, 1: []})
    assert {k: v["value"] for k, v in got.items()} == {"frames_wrong": 0, "window_unmatched": 0}
    got = ensenso.Cell.compare([(0, b), (1, [])], {0: [], 1: []})
    assert {k: v["value"] for k, v in got.items()} == {"frames_wrong": 1, "window_unmatched": 1}


def test_the_condition_reader():
    """A number where the program has the span; None for a program without
    it, even where the batch span is there."""
    got = R.read_metric("condition_ms.ensenso",
                        Ctx(trace("lpe.batch", ["lpe.entry.condition", "lpe.walk"])))
    assert got == pytest.approx(0.004 / 2)
    assert R.read_metric("condition_ms.ensenso", Ctx(trace("lpe.batch", ["lpe.walk"]))) is None


def test_the_fill_reader(monkeypatch):
    from linemod_pose_estimation_tpu_torch.utils import tracing

    ctx = Ctx(trace(None, []))
    monkeypatch.setattr(tracing, "counters", {"pool.coarse_total": 2400,
                                              "pool.coarse_slots": 3072})
    assert R.read_metric("pool_coarse_fill.ensenso", ctx) == pytest.approx(0.78125)
    monkeypatch.setattr(tracing, "counters", {"batch": 3, "sync": 27})
    assert R.read_metric("pool_coarse_fill.ensenso", ctx) is None  # no such counters
    assert R.read_metric("host_syncs_per_batch.ensenso", ctx) == 9


@pytest.mark.parametrize("metric,spans", [
    ("h2d_ms.ensenso", ["lpe.entry.h2d"]), ("preprocess_ms.ensenso", ["lpe.preprocess"]),
    ("pool_bound_ms.ensenso", ["lpe.pool.coarse", "lpe.pool.fine"]),
    ("pool_exact_ms.ensenso", ["lpe.pool.exact"]), ("fallback_ms.ensenso", ["lpe.pool.fallback"]),
    ("walk_ms.ensenso", ["lpe.walk"])])
def test_the_span_readers(metric, spans):
    other = "lpe.sync"
    got = R.read_metric(metric, Ctx(trace("lpe.batch", spans + [other])))
    assert got == pytest.approx(0.004 * len(spans) / 2)
    assert R.read_metric(metric, Ctx(trace("lpe.batch", [other]))) == 0.0
    assert R.read_metric(metric, Ctx(trace(None, [other]))) is None
