"""Pooled matcher: the share of batches that fell back because a frame's
survivors overflowed its select range while the coarse pool held
(`pool.select_overflow` over `batch`)."""

from benchmark.harness.program import counter_ratio


def read(ctx):
    return counter_ratio("pool.select_overflow", "batch")
