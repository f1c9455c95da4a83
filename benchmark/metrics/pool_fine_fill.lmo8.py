"""Pooled matcher over the eight-class merged bank: how full the fine pool
ran, its true survivors over its slots summed over the batches whose fine
stage ran (`pool.fine_total` over `pool.fine_slots`, read in the fine
flag's transfer); past 1.0 the pool overflowed.  None for a program
without the counters."""

from benchmark.harness.program import counter_ratio


def read(ctx):
    return counter_ratio("pool.fine_total", "pool.fine_slots")
