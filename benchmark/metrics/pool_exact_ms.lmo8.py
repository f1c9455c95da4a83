"""Pooled matcher over the eight-class merged bank: device ms per batch of
the exact scores of the pooled survivors over all 21,216 templates and the
per-class selects (`lpe.pool.exact`); 0.0 where every batch overflowed the
coarse pool."""

from benchmark.harness.program import span_device_ms


def read(ctx):
    return span_device_ms(ctx, ["lpe.pool.exact"], "lpe.batch", ctx.steps)
