"""Device: the kernels one detect launches, from the trace, on average."""

from benchmark.harness.readers import kernels_per_parent


def read(ctx):
    return kernels_per_parent(ctx, "detect")
