"""Pooled matcher over the eight-class merged bank: how full the coarse
pool ran, its true survivors over its slots summed over the batches
(`pool.coarse_total` over `pool.coarse_slots`, read in the coarse flag's
transfer); past 1.0 the pool overflowed.  None for a program without the
counters."""

from benchmark.harness.program import counter_ratio


def read(ctx):
    return counter_ratio("pool.coarse_total", "pool.coarse_slots")
