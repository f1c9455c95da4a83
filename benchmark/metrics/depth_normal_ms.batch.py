"""Preprocess: device ms per batch of DepthNormal's quantization and 5x5
median (the program's `lpe.preprocess.depth_normal` span, inside
`ops/match.py::preprocess_frames_batched`; its K2 calls are not in it)."""

from benchmark.harness.program import span_device_ms


def read(ctx):
    return span_device_ms(ctx, ["lpe.preprocess.depth_normal"], "lpe.batch", ctx.steps)
