"""Walk over the eight classes' merged candidates (K3, up to 8 x 128 slots
a frame): device ms per batch of the program's `lpe.walk` span."""

from benchmark.harness.program import span_device_ms


def read(ctx):
    return span_device_ms(ctx, ["lpe.walk"], "lpe.batch", ctx.steps)
