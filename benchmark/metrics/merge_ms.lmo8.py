"""Merged matcher, eight classes: device ms per batch of merging the
classes' candidates (8 x 128 slots a frame) into one similarity-sorted list
before the walk (the program's `lpe.merge` span); None for a program
without the span."""

from benchmark.harness.readers import span_device_ms_per


def read(ctx):
    return span_device_ms_per(ctx, "lpe.merge", ctx.steps)
