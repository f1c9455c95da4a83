"""Trainer host extraction (`models/trainer.py::add_views`): host ms per
view trained in the traced calls."""

from benchmark.harness.readers import span_host_ms_per


def read(ctx):
    return span_host_ms_per(ctx, "extract", ctx.units)
