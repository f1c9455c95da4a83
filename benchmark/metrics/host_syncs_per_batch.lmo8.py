"""Pooled matcher over the eight-class merged bank: host syncs per batch
step (the program's `sync` over its `batch` counter): flag reads, the
frames' copies to the card and host numbers copied to it."""

from benchmark.harness.program import counter_ratio


def read(ctx):
    return counter_ratio("sync", "batch")
