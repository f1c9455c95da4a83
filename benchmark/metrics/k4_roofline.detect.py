"""Kernel K4 (`csrc/raster_zbuffer.cu`: clear, bin, raster) in detect: its
roofline's least time over its traced device time, in percent."""

from benchmark.harness.readers import roofline_pct
from benchmark.harness.spans import K4


def read(ctx):
    return roofline_pct(ctx, K4, per_launch=3)
