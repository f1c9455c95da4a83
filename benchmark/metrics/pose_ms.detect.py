"""Pose (`models/cascade.py::rough_pose_and_refine`: render K4, ICP, HV):
the median over detects of its time from entry to the end of its last
kernel."""

from benchmark.harness.readers import p50_per_parent


def read(ctx):
    return p50_per_parent(ctx, "pose", "detect")
