"""Single-frame match (`models/detector.py::Detector.match_raw`): the median
over detects of the time from entering it to the end of its last kernel."""

from benchmark.harness.readers import p50_per_parent


def read(ctx):
    return p50_per_parent(ctx, "match", "detect")
