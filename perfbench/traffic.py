"""The one generator of every traffic mix: a schedule of sort calls.

A mix is a data file ``perfbench/traffic/<name>.json``:

* ``sizes``: records per call; each cycle of the closed loop sorts every
  size once, in an order drawn from the seed, so every seed sorts the
  same set of sizes;
* ``pool_factor``: the input pool holds ``pool_factor * max(sizes)``
  records; call ``i`` sorts the rows ``[offset, offset + n)`` of the
  pool, at an offset drawn from the seed, so no two calls sort the same
  array;
* ``checked_calls``: how many of the first cycle's calls, drawn from the
  seed, keep their answers for the check after the window (the harness
  also checks the first call down each of ``sort_device``'s paths, and
  the window's last call);
* ``loop`` / ``clients``: ``closed`` with 1 client is what the harness
  runs.
"""

from __future__ import annotations

import numpy as np


class Schedule:
    """The calls of one run: ``call(i) -> (n, offset)``, drawn lazily
    from the seed in call order, so a seed always gives the same calls."""

    def __init__(self, traffic: dict, seed: int):
        if traffic.get("loop", "closed") != "closed" or traffic.get("clients", 1) != 1:
            raise ValueError("the harness runs a closed loop with 1 client")
        self.sizes = [int(n) for n in traffic["sizes"]]
        if not self.sizes or min(self.sizes) < 1:
            raise ValueError("a mix needs positive sizes")
        self.pool_records = int(traffic["pool_factor"] * max(self.sizes))
        if self.pool_records < max(self.sizes):
            raise ValueError("pool_factor below 1")
        self._rng = np.random.default_rng(np.random.SeedSequence(seed % 2**64))
        self.device_seed = int(self._rng.integers(0, 2**63))
        k = min(int(traffic.get("checked_calls", 1)), len(self.sizes))
        self.checked = sorted(
            int(i) for i in self._rng.choice(len(self.sizes), k, replace=False)
        )
        self._calls: list[tuple[int, int]] = []

    def call(self, i: int) -> tuple[int, int]:
        while len(self._calls) <= i:
            for j in self._rng.permutation(len(self.sizes)):
                n = self.sizes[j]
                off = int(self._rng.integers(0, self.pool_records - n + 1))
                self._calls.append((n, off))
        return self._calls[i]
