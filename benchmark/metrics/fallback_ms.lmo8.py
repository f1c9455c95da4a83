"""Pooled matcher over the eight-class merged bank: device ms per batch of
the exhaustive fallback, its exact scores over every position and its
per-class selects (`lpe.pool.fallback`); 0.0 where no batch fell back."""

from benchmark.harness.program import span_device_ms


def read(ctx):
    return span_device_ms(ctx, ["lpe.pool.fallback"], "lpe.batch", ctx.steps)
