"""Trainer: host ms per chunk spent waiting for the chunk's render and
quantizations to reach the host (`lpe.trainer.wait`)."""

from benchmark.harness.program import span_host_ms


def read(ctx):
    return span_host_ms(ctx, "lpe.trainer.wait", "lpe.train")
