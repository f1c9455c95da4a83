"""Device: the share of the traced window in which no kernel, copy or fill
ran on the card."""

from benchmark.harness.readers import idle_share


def read(ctx):
    return idle_share(ctx)
