"""Entry, conditioned frames (`models/serving.py::_frames` with a
FrameConditioning): device ms per batch of turning the raw mono frames into
the cropped, blurred three-channel batch on the card (the program's
`lpe.entry.condition` span, `ops/features.py::condition_frames`); None for
a program without the span."""

from benchmark.harness.readers import span_device_ms_per


def read(ctx):
    return span_device_ms_per(ctx, "lpe.entry.condition", ctx.steps)
