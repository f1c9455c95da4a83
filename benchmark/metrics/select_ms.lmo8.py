"""Pooled matcher over the eight-class merged bank: device ms per batch of
the per-class selects, each frame's pool rows gathered once and one select
a class over its own columns (the program's `lpe.pool.select` span, inside
`lpe.pool.exact`); None for a program without the span."""

from benchmark.harness.readers import span_device_ms_per


def read(ctx):
    return span_device_ms_per(ctx, "lpe.pool.select", ctx.steps)
