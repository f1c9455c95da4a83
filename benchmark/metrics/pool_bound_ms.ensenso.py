"""Pooled matcher over the colour-only bank: device ms per batch of its
bounds, the group and cell bounds with the coarse pool (`lpe.pool.coarse`)
and the g x g fine re-test with its compaction (`lpe.pool.fine`)."""

from benchmark.harness.program import span_device_ms


def read(ctx):
    return span_device_ms(ctx, ["lpe.pool.coarse", "lpe.pool.fine"], "lpe.batch", ctx.steps)
