"""Reductions over the program's own spans and counters
(`linemod_pose_estimation_tpu_torch/utils/tracing.py`): the `lpe.*`
ranges it enters while a profiler runs, and the counters it keeps in
every run.

A span reduction returns 0.0 where the trace holds the span's parent (a
tier that did not run cost nothing), and None where it holds no parent
either (a program without these spans).  A counter ratio returns None
where the program keeps no such counters."""

from __future__ import annotations


def span_device_ms(ctx, spans: list[str], parent: str, per: int) -> float | None:
    """The device time of the ops that instances of `spans` launched,
    summed and divided by `per` (steps)."""
    tr = ctx.trace
    if not tr.span_count(parent) or not per:
        return None
    return sum(sum(tr.span_device_ms(s)) for s in spans) / per


def span_host_ms(ctx, span: str, parent: str, per: int | None = None) -> float | None:
    """The host time inside instances of `span`, summed, over `per` (None:
    over the instances)."""
    tr = ctx.trace
    if not tr.span_count(parent):
        return None
    ivs = tr.spans.get(span, [])
    n = len(ivs) if per is None else per
    return sum(b - a for a, b in ivs) / 1e3 / n if ivs and n else 0.0


def counter_ratio(num: str, den: str) -> float | None:
    """counters[num] / counters[den], both counted by the program over the
    process's steps (warm-up included)."""
    try:
        from linemod_pose_estimation_tpu_torch.utils import tracing
    except ImportError:
        return None
    d = tracing.counters.get(den, 0)
    return tracing.counters.get(num, 0) / d if d else None
