"""Pooled matcher: the share of the window's batches that took the exhaustive
fallback (`BatchedMatcher.last_pool.fallback`, read after each batch)."""


def read(ctx):
    flags = ctx.counters.get("pool_fallback", [])
    return sum(flags) / len(flags) if flags else None
