"""Trainer host extraction: candidates that enter the scattered selection
per view, summed over modalities and levels (`extract.candidates` over
`extract.views`); the selection's cost scales with them."""

from benchmark.harness.program import counter_ratio


def read(ctx):
    return counter_ratio("extract.candidates", "extract.views")
