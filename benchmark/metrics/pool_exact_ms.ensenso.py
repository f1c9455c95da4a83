"""Pooled matcher over the colour-only bank: device ms per batch of the
exact scores over the pooled survivors and the selects (`lpe.pool.exact`);
0.0 where every batch overflowed the coarse pool."""

from benchmark.harness.program import span_device_ms


def read(ctx):
    return span_device_ms(ctx, ["lpe.pool.exact"], "lpe.batch", ctx.steps)
