"""Merged matcher: device ms per batch of merging the classes' candidates
into one similarity-sorted list before the walk (the program's `lpe.merge`
span, `ops/match.py::merge_candidates_sorted`); None for a program without
the span."""

from benchmark.harness.readers import span_device_ms_per


def read(ctx):
    return span_device_ms_per(ctx, "lpe.merge", ctx.steps)
