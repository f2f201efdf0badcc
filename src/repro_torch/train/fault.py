"""Fault-tolerance utilities for long-running multi-pod jobs.

Copy of ``src/repro/train/fault.py`` for the PyTorch port (it imports
neither JAX nor the reference; the restore it names is
``repro_torch.train.checkpoint.restore``).

* ``RetryPolicy.run`` — retries a step through transient failures
  (preemption-shaped exceptions), restoring from the last committed
  checkpoint before re-executing.
* ``StragglerWatchdog`` — EWMA step-time monitor; flags steps slower than
  ``threshold`` x the moving average.  At the launcher level a flagged
  host is a candidate for exclusion + elastic restart (the restore path
  re-shards onto the shrunken mesh — see checkpoint.restore).
* ``Heartbeat`` — per-process liveness file the launcher can poll.

These are deliberately host-side and framework-agnostic: on a real
cluster the *decisions* (kill/restart/reshard) belong to the scheduler;
the framework's job is to make every step restartable, which
checkpoint.py's atomic-commit + elastic restore provides.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable


@dataclasses.dataclass
class RetryPolicy:
    max_retries: int = 3
    backoff_s: float = 1.0
    retryable: tuple = (RuntimeError, OSError)

    def run(self, fn: Callable, on_retry: Callable | None = None):
        last = None
        for attempt in range(self.max_retries + 1):
            try:
                return fn()
            except self.retryable as e:  # pragma: no cover - timing
                last = e
                if attempt == self.max_retries:
                    raise
                time.sleep(self.backoff_s * (2**attempt))
                if on_retry is not None:
                    on_retry(attempt, e)
        raise last  # unreachable


class StragglerWatchdog:
    def __init__(self, threshold: float = 2.0, alpha: float = 0.1):
        self.threshold = threshold
        self.alpha = alpha
        self.ewma: float | None = None
        self.flagged: list[tuple[int, float]] = []

    def observe(self, step: int, seconds: float) -> bool:
        """Returns True if this step is a straggler."""
        if self.ewma is None:
            self.ewma = seconds
            return False
        is_straggler = seconds > self.threshold * self.ewma
        if is_straggler:
            self.flagged.append((step, seconds))
        # slow steps must not poison the baseline
        w = self.alpha if not is_straggler else self.alpha * 0.1
        self.ewma = (1 - w) * self.ewma + w * seconds
        return is_straggler


class Heartbeat:
    """Rate-limited liveness file.

    The beat interval is measured on a monotonic clock (``time.time``
    jumps under NTP slew/step and can suppress or burst beats); the file
    *content* keeps wall time so the launcher's poller can compare it
    against its own clock.  ``clock`` is injectable for tests.
    """

    def __init__(
        self,
        path: str,
        interval_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.path = path
        self.interval_s = interval_s
        self.clock = clock
        self._last: float | None = None  # None -> first beat always fires

    def beat(self, step: int) -> None:
        now = self.clock()
        if self._last is not None and now - self._last < self.interval_s:
            return
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.write(f"{step} {time.time()}\n")
        os.replace(tmp, self.path)
        self._last = now
