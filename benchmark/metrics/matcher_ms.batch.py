"""Pooled matcher (`ops/match.py::match_pooled_fine_with_fallback`, the
exhaustive fallback included): device ms per batch."""

from benchmark.harness.readers import span_device_ms_per


def read(ctx):
    return span_device_ms_per(ctx, "pooled_matcher", ctx.steps)
