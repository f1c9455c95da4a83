"""Pooled matcher over the colour-only bank: device ms per batch of the
exhaustive fallback, the exact scores at every cell and the select
(`lpe.pool.fallback`); 0.0 where no batch fell back."""

from benchmark.harness.program import span_device_ms


def read(ctx):
    return span_device_ms(ctx, ["lpe.pool.fallback"], "lpe.batch", ctx.steps)
