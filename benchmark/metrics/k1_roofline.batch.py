"""Kernel K1 (`csrc/quantize_cg.cu`) in the batch: its roofline's least time
over its traced device time, in percent."""

from benchmark.harness.readers import roofline_pct
from benchmark.harness.spans import K1


def read(ctx):
    return roofline_pct(ctx, K1)
