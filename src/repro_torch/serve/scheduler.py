"""FIFO continuous-batching scheduler with admission control (copy of
``src/repro/serve/scheduler.py``; DESIGN.md §14).

The serving analogue of the sort executor's super-batches: concurrent
point/range lookups coalesce into device-sized batches instead of
dispatching per request.  The admission window is the classic
continuous-batching rule (rtp-llm's ``FIFOScheduler`` shape): a batch
dispatches as soon as **``max_batch`` requests have queued OR the
oldest has waited ``max_wait``** — light load pays at most one wait
window of latency, heavy load forms full batches back to back and the
wait never fires.

Admission control bounds the queue at ``max_queue``: a submission
beyond it is rejected *immediately* with the typed :class:`Overloaded`
(load shedding).  Under open-loop overload the queue therefore holds at
most ``max_queue`` requests and p99 stays bounded at roughly
``max_queue / service_rate`` instead of growing without limit.

The scheduler is transport-agnostic and owns no threads: the server's
batch loop awaits :meth:`next_batch` and resolves each request's
future; unit tests drive it directly under ``asyncio.run``.
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import time

from repro_torch.core.stages.stats import ServeStats


class Overloaded(Exception):
    """Typed load-shed rejection: the admission queue is at capacity.

    Carries the observed depth and the bound so the transport layer can
    surface a structured error (the line protocol maps this to
    ``{"ok": false, "error": "overloaded"}``)."""

    def __init__(self, depth: int, bound: int):
        super().__init__(
            f"admission queue at capacity ({depth}/{bound}); shedding"
        )
        self.depth = depth
        self.bound = bound


@dataclasses.dataclass
class Request:
    """One admitted query: resolved through ``future`` by the batch loop."""

    kind: str  # "point" | "range"
    payload: object  # point: key bytes; range: (lo_key, hi_key) bytes
    future: asyncio.Future
    t_submit: float
    seq: int  # admission order — FIFO position


class FifoBatchScheduler:
    """Coalesce admitted requests into FIFO batches under the
    max-batch/max-wait window."""

    def __init__(
        self,
        *,
        max_batch: int = 64,
        max_wait_s: float = 0.002,
        max_queue: int = 1024,
        stats: "ServeStats | None" = None,
        clock=time.monotonic,
    ):
        if max_batch < 1 or max_queue < 1:
            raise ValueError(
                f"max_batch and max_queue must be >= 1, got "
                f"{max_batch}/{max_queue}"
            )
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.max_queue = max_queue
        self.stats = stats if stats is not None else ServeStats()
        self.stats.batch_slot_limit = max_batch
        self._clock = clock
        self._q: collections.deque[Request] = collections.deque()
        self._wake: asyncio.Event | None = None  # bound to the loop lazily
        self._seq = 0
        self._closed = False

    # -- admission -----------------------------------------------------

    @property
    def depth(self) -> int:
        return len(self._q)

    @property
    def closed(self) -> bool:
        return self._closed

    def _event(self) -> asyncio.Event:
        if self._wake is None:
            self._wake = asyncio.Event()
        return self._wake

    def submit(self, kind: str, payload) -> asyncio.Future:
        """Admit one request; returns the future the batch loop will
        resolve.  Raises :class:`Overloaded` beyond ``max_queue`` and
        ``RuntimeError`` once draining — both *before* enqueueing, so a
        rejected request costs the caller nothing but the round trip."""
        if self._closed:
            raise RuntimeError("scheduler is draining; not accepting work")
        if len(self._q) >= self.max_queue:
            self.stats.n_shed += 1
            raise Overloaded(len(self._q), self.max_queue)
        fut = asyncio.get_running_loop().create_future()
        self._q.append(
            Request(kind, payload, fut, self._clock(), self._seq)
        )
        self._seq += 1
        self._event().set()
        return fut

    # -- batch formation -----------------------------------------------

    async def next_batch(self) -> "list[Request] | None":
        """Block until a batch is due, then pop it (FIFO prefix of the
        queue).  Returns ``None`` exactly once the scheduler is closed
        AND the queue has drained — the batch loop's exit signal."""
        wake = self._event()
        while not self._q:
            if self._closed:
                return None
            wake.clear()
            await wake.wait()
        # window: dispatch at max_batch, or when the OLDEST queued
        # request has waited max_wait (not the newest — otherwise a
        # trickle of arrivals could postpone dispatch forever)
        deadline = self._q[0].t_submit + self.max_wait_s
        while len(self._q) < self.max_batch and not self._closed:
            remaining = deadline - self._clock()
            if remaining <= 0:
                break
            wake.clear()
            try:
                await asyncio.wait_for(wake.wait(), timeout=remaining)
            except asyncio.TimeoutError:
                break
        depth = len(self._q)
        batch = [
            self._q.popleft() for _ in range(min(self.max_batch, depth))
        ]
        self.stats.n_batches += 1
        self.stats.batched_requests += len(batch)
        self.stats.queue_depth_sum += depth
        self.stats.queue_depth_peak = max(
            self.stats.queue_depth_peak, depth
        )
        return batch

    # -- drain ---------------------------------------------------------

    def close(self) -> None:
        """Stop admitting; queued work still dispatches (graceful
        drain).  ``next_batch`` returns ``None`` once empty."""
        self._closed = True
        if self._wake is not None:
            self._wake.set()

    def abort_pending(self, exc: Exception) -> int:
        """Fail every queued request (non-graceful teardown)."""
        n = 0
        while self._q:
            req = self._q.popleft()
            if not req.future.done():
                req.future.set_exception(exc)
                n += 1
        return n
