"""Preprocess (`ops/match.py::preprocess_frames_batched`): device ms per
batch of the kernels it launched (K1, K2, pyrDown, DepthNormal)."""

from benchmark.harness.readers import span_device_ms_per


def read(ctx):
    return span_device_ms_per(ctx, "preprocess", ctx.steps)
