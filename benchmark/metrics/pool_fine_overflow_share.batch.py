"""Pooled matcher: the share of batches whose fine pool overflowed
(`pool.fine_overflow` over `batch`); such a batch scores the coarse pool."""

from benchmark.harness.program import counter_ratio


def read(ctx):
    return counter_ratio("pool.fine_overflow", "batch")
