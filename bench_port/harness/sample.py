"""A seeded sample of what a window produced, kept in bounded memory.

Reservoir sampling (Algorithm R) over the items in the order they come,
its draws from the run seed, plus the largest item seen, so that the
sample holds the longest request whatever the draws.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np


class Keeper:
    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([int(seed) & ((1 << 64) - 1), 0x5EED])
        self.seen = 0
        self.reservoir: List[Tuple[int, Any]] = []
        self.largest: Tuple[float, int, Any] = (-1.0, -1, None)

    def offer(self, key: int, size: float, item: Any) -> None:
        """Item ``key`` of size ``size`` (its vertex count, say)."""
        if size > self.largest[0]:
            self.largest = (size, key, item)
        if len(self.reservoir) < self.k:
            self.reservoir.append((key, item))
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.reservoir[j] = (key, item)
        self.seen += 1

    def items(self) -> List[Tuple[int, Any]]:
        """(key, item) of the sample, the largest first, each key once."""
        out = [] if self.largest[2] is None else [(self.largest[1], self.largest[2])]
        keys = {k for k, _ in out}
        return out + sorted((k, v) for k, v in self.reservoir if k not in keys)
