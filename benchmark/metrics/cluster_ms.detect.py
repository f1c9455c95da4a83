"""Clustering (`models/cascade.py::cluster_matches` and `nms_iou`): the
median over detects of their summed time from entry to the end of their
last kernels."""

from benchmark.harness.readers import p50_per_parent


def read(ctx):
    return p50_per_parent(ctx, "cluster", "detect")
