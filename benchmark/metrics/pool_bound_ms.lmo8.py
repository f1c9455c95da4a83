"""Pooled matcher over the eight-class merged bank: device ms per batch of
its bounds, the cell bound over every level-1 position with the coarse
pool (`lpe.pool.coarse`; the merged path has no group tier) and the g x g
fine re-test with its compaction (`lpe.pool.fine`)."""

from benchmark.harness.program import span_device_ms


def read(ctx):
    return span_device_ms(ctx, ["lpe.pool.coarse", "lpe.pool.fine"], "lpe.batch", ctx.steps)
