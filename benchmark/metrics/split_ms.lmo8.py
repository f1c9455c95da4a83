"""Merged matcher, eight classes: device ms per batch of splitting the
walked matches by class and re-gating each at its own threshold (the
program's `lpe.split` span); None for a program without the span."""

from benchmark.harness.readers import span_device_ms_per


def read(ctx):
    return span_device_ms_per(ctx, "lpe.split", ctx.steps)
