"""Pooled matcher over the colour-only bank: the share of batches whose
coarse pool overflowed (`pool.coarse_overflow` over `batch`); each such
batch falls back to the exhaustive scores."""

from benchmark.harness.program import counter_ratio


def read(ctx):
    return counter_ratio("pool.coarse_overflow", "batch")
