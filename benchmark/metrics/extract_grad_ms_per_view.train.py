"""Trainer host extraction: ms per view of the gradient features' candidate
build and scattered selection (`lpe.extract.grad`, one span a level)."""

from benchmark.harness.program import span_host_ms


def read(ctx):
    return span_host_ms(ctx, "lpe.extract.grad", "lpe.train", ctx.units)
