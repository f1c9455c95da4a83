"""Entry: device ms per batch of the one copy of the pageable raw mono
frames (B x 480 x 752 u8) to the card (the program's `lpe.entry.h2d` span)."""

from benchmark.harness.program import span_device_ms


def read(ctx):
    return span_device_ms(ctx, ["lpe.entry.h2d"], "lpe.batch", ctx.steps)
