"""What the drivers share: paths of a configuration's files, the seed's
draws, and the numbers a run compares with their limits."""

from __future__ import annotations

import os

import numpy as np

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bank_path(config: dict) -> str:
    return os.path.join(BENCH, config["templates"])


def params_path(config: dict) -> str:
    return os.path.join(BENCH, config["params"])


def rng(seed: int, stream: int) -> np.random.Generator:
    """The seed's generator for one purpose (`stream`), any seed up to 2**63."""
    return np.random.default_rng([int(seed) & (2**63 - 1), stream])


def seeded_templates(seed: int, n: int, k: int) -> np.ndarray:
    """k distinct template ids of n, drawn from the seed."""
    return np.sort(rng(seed, 1).choice(n, size=k, replace=False))


class Limits:
    """The limit of each number a run compares: a run is correct when every
    number is at most its limit."""

    def __init__(self, **limits: float):
        self.limits = limits

    def numbers(self, **values: float) -> dict:
        missing = set(self.limits) ^ set(values)
        if missing:
            raise ValueError(f"numbers without a limit or a value: {sorted(missing)}")
        return {k: {"value": values[k], "limit": self.limits[k]} for k in self.limits}
