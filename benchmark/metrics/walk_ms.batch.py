"""Walk (`ops/match.py::refine_candidates_opencv_batched`, K3): device ms
per batch."""

from benchmark.harness.readers import span_device_ms_per


def read(ctx):
    return span_device_ms_per(ctx, "walk", ctx.steps)
