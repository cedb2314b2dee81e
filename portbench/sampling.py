"""A seeded uniform sample of a window's answers, of a fixed size, kept
without copying anything in the window (reservoir sampling)."""

from __future__ import annotations

from typing import Any, List

import numpy as np


class Reservoir:
    def __init__(self, size: int, seed: int):
        self.size, self.seen = size, 0
        self.items: List[Any] = []
        self._rng = np.random.default_rng([seed, 3])

    def add(self, item: Any) -> None:
        j = len(self.items) if len(self.items) < self.size else int(self._rng.integers(0, self.seen + 1))
        if j < self.size:
            self.items[j : j + 1] = [item]
        self.seen += 1
