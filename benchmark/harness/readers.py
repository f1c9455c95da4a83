"""Reductions that the per-layer metric files (`benchmark/metrics/`) share.
Each returns None where the trace holds nothing to read."""

from __future__ import annotations

import statistics


def span_device_ms_per(ctx, span: str, per: int) -> float | None:
    """The device time of the ops that instances of `span` launched, summed
    and divided by `per` (batches, chunks)."""
    ms = ctx.trace.span_device_ms(span)
    return sum(ms) / per if ms and per else None


def span_host_ms_per(ctx, span: str, per: int) -> float | None:
    """The host time inside instances of `span`, summed, over `per`."""
    ivs = ctx.trace.spans.get(span, [])
    return sum(b - a for a, b in ivs) / 1e3 / per if ivs and per else None


def p50_per_parent(ctx, span: str, parent: str) -> float | None:
    """The median over instances of `parent` of the summed time from the
    host entering each `span` inside it to the end of its last device op."""
    tr = ctx.trace
    kids = list(zip(tr.spans.get(span, []), tr.span_to_last_op_ms(span)))
    per = [sum(ms for (a, _), ms in kids if p0 <= a <= p1)
           for p0, p1 in tr.spans.get(parent, [])]
    return statistics.median(per) if kids and per else None


def kernels_per_parent(ctx, parent: str) -> float | None:
    """Kernels (not copies or fills) launched inside instances of `parent`,
    on average."""
    ops = ctx.trace.span_ops(parent)
    n = [sum(not o[2].startswith(("Memcpy", "Memset")) for o in inst) for inst in ops]
    return sum(n) / len(n) if n else None


def roofline_pct(ctx, fragment: str, per_launch: int = 1) -> float | None:
    """A kernel's share of its roofline in percent: the least time of its
    launches (the launch records, from the frozen roofline copy) over the
    device time the trace holds of them.  A launch of K4 is three kernels
    (`per_launch`).  Where the trace lost records the launches it holds are
    taken at their mean bound."""
    ks = ctx.trace.kernels(fragment)
    bounds = ctx.launches.get(fragment, [])
    if not ks or not bounds or len(ks) % per_launch:
        return None
    n = len(ks) // per_launch
    least = sum(bounds) if n == len(bounds) else n * sum(bounds) / len(bounds)
    return 100.0 * least / (sum(e - s for s, e, _, _ in ks) / 1e3)


def idle_share(ctx) -> float | None:
    w = ctx.trace.window_s
    return 1.0 - ctx.trace.busy_s / w if w > 0 else None
