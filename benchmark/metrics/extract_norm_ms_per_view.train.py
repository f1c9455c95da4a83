"""Trainer host extraction: ms per view of the normal features: the
distance transform, the candidate build and the scattered selection
(`lpe.extract.norm`, one span a level)."""

from benchmark.harness.program import span_host_ms


def read(ctx):
    return span_host_ms(ctx, "lpe.extract.norm", "lpe.train", ctx.units)
