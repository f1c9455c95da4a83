"""The reductions: rates and tails over every request of a window, and the
device's busy and idle share, span times and roofline shares from a
synthetic profiler trace."""

import numpy as np
import pytest

from benchmark.harness import batch, detect, readers, train
from benchmark.harness.trace import WINDOW, Trace


def ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic():
    """A 100 us window: span "a" (10-40) launches k1 (corr 1, 20-30 on the
    device) and k2 (corr 2, 35-60); span "b" (50-70) launches a copy
    (corr 3, 65-80) and k1 again (corr 4, 85-95)."""
    return [
        ev("user_annotation", WINDOW, 0, 100),
        ev("user_annotation", "a", 10, 30), ev("user_annotation", "b", 50, 20),
        ev("user_annotation", "parent", 5, 90),
        ev("cuda_runtime", "cudaLaunchKernel", 12, 1, 1),
        ev("cuda_runtime", "cudaLaunchKernel", 30, 1, 2),
        ev("cuda_runtime", "cudaMemcpyAsync", 55, 1, 3),
        ev("cuda_runtime", "cudaLaunchKernel", 60, 1, 4),
        ev("kernel", "void k1<int>(int)", 20, 10, 1),
        ev("kernel", "k2", 35, 25, 2),
        ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 65, 15, 3),
        ev("kernel", "void k1<int>(int)", 85, 10, 4),
        ev("cpu_op", "aten::add", 60, 5),
    ]


def test_busy_idle_and_spans():
    t = Trace(synthetic())
    assert t.window_s == pytest.approx(100e-6)
    # busy: [20, 30] + [35, 60] + [65, 80] + [85, 95] = 60 us
    assert t.busy_s == pytest.approx(60e-6)

    class Ctx:
        trace = t
    assert readers.idle_share(Ctx) == pytest.approx(0.40)
    assert t.span_device_ms("a") == pytest.approx([0.035])
    assert t.span_device_ms("b") == pytest.approx([0.025])
    # from entering "a" (10) to the end of its last op (60)
    assert t.span_to_last_op_ms("a") == pytest.approx([0.050])
    assert t.span_to_last_op_ms("b") == pytest.approx([0.045])
    Ctx.launches, Ctx.steps = {}, 2
    assert readers.span_device_ms_per(Ctx, "a", 2) == pytest.approx(0.0175)
    assert readers.p50_per_parent(Ctx, "a", "parent") == pytest.approx(0.050)
    assert readers.kernels_per_parent(Ctx, "parent") == 3  # the copy is not a kernel
    assert readers.span_device_ms_per(Ctx, "absent", 2) is None
    bd = t.breakdown()
    assert bd["device_ops"][0] == ["k2", pytest.approx(25e-6)]
    assert bd["device_ops"][1][0] == "k1<int>(int)"
    # the longest gap, [0, 20], is named by the innermost span at its
    # middle (10: "a", inside "parent"); the next ones last 5 us
    assert bd["idle_gaps"][0] == ["a / python", pytest.approx(20e-6)]
    assert [g[1] for g in bd["idle_gaps"][1:]] == pytest.approx([5e-6] * 4)
    assert ["b / aten::add", pytest.approx(5e-6)] in bd["idle_gaps"]


def test_roofline_share():
    t = Trace(synthetic())

    class Ctx:
        trace = t
        launches = {"k1": [0.002, 0.004]}
    # least 6 us over 20 us of k1 on the device
    assert readers.roofline_pct(Ctx, "k1") == pytest.approx(30.0)
    Ctx.launches = {"k1": [0.002, 0.004, 0.006]}  # the trace lost a launch: mean bound
    assert readers.roofline_pct(Ctx, "k1") == pytest.approx(40.0)
    assert readers.roofline_pct(Ctx, "k9") is None
    assert readers.roofline_pct(Ctx, "k1", per_launch=3) is None


def test_rates_and_tails_over_every_request():
    times = list(np.arange(1, 201, dtype=float))  # 200 requests, 1..200 ms
    e = detect.Cell.end_to_end(None, 200, 10.0, times)
    assert e["detect_ms_p50"] == pytest.approx(100.5)
    assert e["detect_ms_p95"] == pytest.approx(np.percentile(times, 95))
    assert batch.Cell.end_to_end(None, 32 * 10, 2.0, [])["frames_per_s"] == 160.0
    assert train.Cell.end_to_end(None, 512, 4.0, [])["train_views_per_s"] == 128.0
