"""Walk over the colour-only candidates (`ops/match.py::refine_candidates_opencv_batched`,
K3, up to top_k slots a frame): device ms per batch of the program's
`lpe.walk` span."""

from benchmark.harness.program import span_device_ms


def read(ctx):
    return span_device_ms(ctx, ["lpe.walk"], "lpe.batch", ctx.steps)
