"""Trainer device work (`models/trainer.py::_ChunkOnDevice`: render K4,
`templates.quantize_levels`, the copies to pinned memory): device ms per
chunk."""

from benchmark.harness.readers import span_device_ms_per


def read(ctx):
    return span_device_ms_per(ctx, "chunk", ctx.trace.span_count("chunk"))
