"""Preprocess of the colour-only bank (`ops/match.py::preprocess_frames_batched`
at 8 channels, no DepthNormal): device ms per batch of K1 x2, pyrDown and
K2 x2 (the program's `lpe.preprocess` span)."""

from benchmark.harness.program import span_device_ms


def read(ctx):
    return span_device_ms(ctx, ["lpe.preprocess"], "lpe.batch", ctx.steps)
