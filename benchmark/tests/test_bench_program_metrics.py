"""The readers of the program's own spans and counters
(`benchmark/harness/program.py` and the metrics that use it) on a
synthetic trace and on set counters: a number where the program's spans
or counters are there, 0.0 for a tier that did not run inside a traced
step, None where the program has no such spans or counters at all."""

import sys

import pytest

from benchmark import run as R
from benchmark.harness.trace import WINDOW, Trace

BATCH_SPANS = {
    "depth_normal_ms.batch": ["lpe.preprocess.depth_normal"],
    "pool_bound_ms.batch": ["lpe.pool.coarse", "lpe.pool.fine"],
    "pool_exact_ms.batch": ["lpe.pool.exact"],
    "fallback_ms.batch": ["lpe.pool.fallback"],
}
TRAIN_SPANS = {
    "extract_grad_ms_per_view.train": "lpe.extract.grad",
    "extract_norm_ms_per_view.train": "lpe.extract.norm",
    "trainer_wait_ms_per_chunk.train": "lpe.trainer.wait",
}
COUNTERS = {
    "host_syncs_per_batch.batch": ("sync", "batch"),
    "pool_coarse_overflow_share.batch": ("pool.coarse_overflow", "batch"),
    "pool_fine_overflow_share.batch": ("pool.fine_overflow", "batch"),
    "pool_select_overflow_share.batch": ("pool.select_overflow", "batch"),
    "select_candidates_per_view.train": ("extract.candidates", "extract.views"),
}


def ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def trace(parent: str | None, children: list[str]) -> Trace:
    """A 100 us window; `parent` spans 0-100 with each child span in a
    slot of its own, 10 us long, launching one 4 us kernel."""
    events = [ev("user_annotation", WINDOW, 0, 100)]
    if parent:
        events.append(ev("user_annotation", parent, 0, 100))
    for i, name in enumerate(children):
        t = 10 * i
        events += [ev("user_annotation", name, t, 10),
                   ev("cuda_runtime", "cudaLaunchKernel", t + 1, 1, i + 1),
                   ev("kernel", f"k{i}", t + 2, 4, i + 1)]
    return Trace(events)


class Ctx:
    def __init__(self, tr, steps=2, units=4):
        self.trace, self.launches, self.counters = tr, {}, {}
        self.steps, self.units = steps, units


@pytest.mark.parametrize("metric", list(BATCH_SPANS))
def test_batch_span_readers(metric):
    spans = BATCH_SPANS[metric]
    other = "lpe.walk"
    # each span 4 us of device time, over 2 steps
    got = R.read_metric(metric, Ctx(trace("lpe.batch", spans + [other])))
    assert got == pytest.approx(0.004 * len(spans) / 2)
    assert R.read_metric(metric, Ctx(trace("lpe.batch", [other]))) == 0.0
    assert R.read_metric(metric, Ctx(trace(None, [other]))) is None


@pytest.mark.parametrize("metric", list(TRAIN_SPANS))
def test_train_span_readers(metric):
    span = TRAIN_SPANS[metric]
    got = R.read_metric(metric, Ctx(trace("lpe.train", [span, span])))
    # two instances of 10 us of host time: per 4 views, or per instance (wait)
    want = 0.010 if metric.startswith("trainer_wait") else 0.020 / 4
    assert got == pytest.approx(want)
    assert R.read_metric(metric, Ctx(trace("lpe.train", ["lpe.trainer.dispatch"]))) == 0.0
    assert R.read_metric(metric, Ctx(trace(None, ["lpe.trainer.dispatch"]))) is None


@pytest.mark.parametrize("metric", list(COUNTERS))
def test_counter_readers(metric, monkeypatch):
    from linemod_pose_estimation_tpu_torch import utils
    from linemod_pose_estimation_tpu_torch.utils import tracing

    num, den = COUNTERS[metric]
    ctx = Ctx(trace(None, []))
    monkeypatch.setattr(tracing, "counters", {num: 3, den: 4})
    assert R.read_metric(metric, ctx) == pytest.approx(0.75)
    monkeypatch.setattr(tracing, "counters", {den: 4})
    assert R.read_metric(metric, ctx) == 0.0
    monkeypatch.setattr(tracing, "counters", {})
    assert R.read_metric(metric, ctx) is None  # no steps counted
    # a program without the counters
    monkeypatch.setattr(tracing, "counters", {num: 3, den: 4})
    monkeypatch.delattr(utils, "tracing")
    monkeypatch.setitem(sys.modules, "linemod_pose_estimation_tpu_torch.utils.tracing", None)
    assert R.read_metric(metric, ctx) is None


def test_every_program_metric_is_in_the_manifest(manifest):
    entries = {m["name"]: m for m in manifest["per_layer"]}
    for metric in {**BATCH_SPANS, **TRAIN_SPANS, **COUNTERS}:
        m = entries[metric]
        assert m["source"] == ("program_counter" if metric in COUNTERS else "program_span")
        cells = ["train-rgbd"] if metric.endswith(".train") else ["batch32-planted",
                                                                  "batch32-fullbin"]
        assert m["workloads"] == cells
