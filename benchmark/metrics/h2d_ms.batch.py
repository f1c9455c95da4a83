"""Entry (`models/serving.py::BatchedMatcher.match_batch`): device ms per
batch of the copy of the pageable batch to the card (`serving._frames`)."""

from benchmark.harness.readers import span_device_ms_per


def read(ctx):
    return span_device_ms_per(ctx, "entry.h2d", ctx.steps)
