"""Instrumentation: ``SortStats`` + ``PhaseClock`` for the pipelined
runtime, ``LatencyReservoir`` + ``ServeStats`` for query serving, and
:func:`span`, the profiler range around each step of the device sort.

Copy of ``src/repro/core/stages/stats.py`` for the PyTorch port.

``SortStats`` is the per-sort instrumentation record every entry point
returns; ``PhaseClock`` is the thread-safe accumulator the stage workers
share while a sort is in flight (``repro_torch.core.pipeline`` and
``repro_torch.core.external`` re-export ``SortStats``).  ``ServeStats``
is its serving sibling, kept by ``repro_torch.serve.server.QueryServer``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time

import numpy as np
from torch.autograd import _profiler_enabled
from torch.profiler import record_function

from repro_torch.data import gensort

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler`` range named ``name`` while a profiler is
    running, else one shared no-op context, so that a span costs one
    check when nothing traces.  The profiler keeps the ranges in memory,
    on the clock of its device trace; nothing is written out here."""
    if _profiler_enabled():
        return record_function(name)
    return _NO_SPAN


class LatencyReservoir:
    """Fixed-size log-bucketed latency sketch.

    ``QueryStats.latencies_s`` was an unbounded Python list — a memory
    leak for a long-lived server appending one float per query.  This
    replacement holds a constant ~2 KB: geometric buckets spanning
    100 ns .. 100 s at ``PER_DECADE`` buckets per decade (each bucket is
    a ~10% latency band, so any percentile is exact to within ±1
    bucket), plus exact min/max for the under/overflow tails.

    The list API the engine used (``append``/``extend``/``len``/
    truthiness) is preserved, so call sites did not change.
    """

    LO = 1e-7
    HI = 1e2
    PER_DECADE = 24
    _DECADES = 9  # log10(HI / LO)
    _N = _DECADES * PER_DECADE + 2  # + underflow/overflow buckets

    def __init__(self):
        self.counts = np.zeros(self._N, dtype=np.int64)
        self.n = 0
        self.min_s = float("inf")
        self.max_s = 0.0

    def __len__(self) -> int:
        return self.n

    def __bool__(self) -> bool:
        return self.n > 0

    def _bucket(self, values: np.ndarray) -> np.ndarray:
        safe = np.maximum(values, 1e-30)
        idx = np.floor(
            (np.log10(safe) - np.log10(self.LO)) * self.PER_DECADE
        ).astype(np.int64) + 1
        return np.clip(idx, 0, self._N - 1)

    def append(self, dt: float) -> None:
        self.extend(np.asarray([dt], dtype=np.float64))

    def extend(self, values) -> None:
        values = np.asarray(values, dtype=np.float64)
        if values.size == 0:
            return
        np.add.at(self.counts, self._bucket(values), 1)
        self.n += int(values.size)
        self.min_s = min(self.min_s, float(values.min()))
        self.max_s = max(self.max_s, float(values.max()))

    def percentile(self, pct: float) -> float:
        """Latency (seconds) at ``pct`` — the geometric center of the
        bucket holding that rank (exact for the min/max tails)."""
        if self.n == 0:
            return 0.0
        if pct <= 0:
            return self.min_s
        if pct >= 100:
            return self.max_s
        rank = min(max(pct / 100.0, 0.0), 1.0) * self.n
        cum = np.cumsum(self.counts)
        i = int(np.searchsorted(cum, max(rank, 1), side="left"))
        if i == 0:
            return self.min_s
        if i >= self._N - 1:
            return self.max_s
        lo_edge = np.log10(self.LO) + (i - 1) / self.PER_DECADE
        mid = 10.0 ** (lo_edge + 0.5 / self.PER_DECADE)
        # a single-bucket population is bracketed by the exact extremes
        return float(min(max(mid, self.min_s), self.max_s))


@dataclasses.dataclass
class SortStats:
    """Instrumentation for one file sort.

    ``phase_seconds`` are busy seconds *summed across workers* (the
    sequential-equivalent cost; identical to the historical accounting when
    ``n_readers == 1``).  ``phase_wall_seconds`` is each phase's span from
    first start to last finish, and ``wall_seconds`` the end-to-end span —
    so ``total_seconds > wall_seconds`` is the signature of phase overlap
    (paper Fig. 6's pipelining effect).

    Executor accounting (DESIGN.md §10): ``device_dispatches`` counts
    jitted sort-graph launches, ``batch_occupancy`` is the mean fraction
    of super-batch slots holding real records, and ``jit_compiles`` the
    number of distinct compiled static shapes the executor touched — the
    three numbers that make the batched device path's win measurable.
    """

    n_records: int = 0
    input_bytes: int = 0
    bytes_read: int = 0
    bytes_written: int = 0
    phase_seconds: dict = dataclasses.field(default_factory=dict)
    partition_counts: list = dataclasses.field(default_factory=list)
    fallbacks: int = 0
    # pipelined-runtime additions
    n_readers: int = 1
    wall_seconds: float = 0.0
    phase_wall_seconds: dict = dataclasses.field(default_factory=dict)
    # set when the sort also emitted a query-serving sidecar (DESIGN.md §7)
    manifest_path: str | None = None
    # sort-executor accounting (DESIGN.md §10)
    executor: str = ""
    device_dispatches: int = 0
    batch_occupancy: float = 0.0
    jit_compiles: int = 0
    # pre-sort planner record (DESIGN.md §11): which partitioner ran,
    # why, the sample diagnostics behind the choice, and the knobs the
    # auto-tuner settled on — so tests/benchmarks assert the *decision*
    planner_decision: str = ""
    planner_reason: str = ""
    planner_diagnostics: dict = dataclasses.field(default_factory=dict)
    tuned_knobs: dict = dataclasses.field(default_factory=dict)
    # warm-start model cache (DESIGN.md §12): "" when no cache was
    # passed, else "hit" (cached model reused, train skipped) or "miss"
    # (band check failed — trained fresh and stored).  ``model_hash`` is
    # the manifest-v3 hash of the model that actually partitioned.
    model_cache: str = ""
    model_hash: str = ""
    # spill fragments that overflowed the RAM budget to disk (physical
    # write bytes; the logical spill traffic stays in bytes_written)
    spill_disk_bytes: int = 0
    # writer-pool accounting (DESIGN.md §15): pool width, bytes each
    # positioned writer issued, and each writer's cumulative queue-wait
    # seconds — near-equal bytes with stall-dominated waits means the
    # disk path is saturated; starved writers point at the sorters
    n_writers: int = 1
    writer_bytes: list = dataclasses.field(default_factory=list)
    writer_stall_seconds: list = dataclasses.field(default_factory=list)

    @property
    def total_seconds(self) -> float:
        return sum(self.phase_seconds.values())

    @property
    def io_bytes(self) -> int:
        return self.bytes_read + self.bytes_written

    @property
    def overlap_seconds(self) -> float:
        """Busy seconds hidden by pipelining/parallelism (0 if sequential)."""
        if not self.wall_seconds:
            return 0.0
        return max(0.0, self.total_seconds - self.wall_seconds)

    def rate_mb_s(self) -> float:
        # sequential baselines (mergesort/terasort) predate ``input_bytes``
        # and keep the fixed-gensort accounting as a fallback
        total = self.input_bytes or self.n_records * gensort.RECORD_BYTES
        elapsed = self.wall_seconds or self.total_seconds
        return total / max(elapsed, 1e-9) / 1e6


class PhaseClock:
    """Thread-safe phase accounting shared by every stage worker.

    ``timer(phase)`` context-manages one busy interval: busy seconds are
    summed per phase and wall spans are merged (min start / max end).
    Integer event counters (device dispatches, batch slots, ...)
    accumulate via ``add_counter`` and land in ``finish``.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self.busy: dict[str, float] = {}
        self.span: dict[str, list[float]] = {}
        self.counters: dict[str, int] = {}
        self.bytes_read = 0
        self.bytes_written = 0

    def timer(self, phase: str) -> "_PhaseTimer":
        return _PhaseTimer(self, phase)

    def add_io(self, read: int = 0, written: int = 0) -> None:
        with self._lock:
            self.bytes_read += read
            self.bytes_written += written

    def add_counter(self, name: str, value: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + value

    def _record(self, phase: str, t0: float, t1: float) -> None:
        with self._lock:
            self.busy[phase] = self.busy.get(phase, 0.0) + (t1 - t0)
            span = self.span.setdefault(phase, [t0, t1])
            span[0] = min(span[0], t0)
            span[1] = max(span[1], t1)

    def finish(self, stats: SortStats) -> None:
        stats.wall_seconds = time.perf_counter() - self._t0
        stats.phase_seconds = dict(self.busy)
        stats.phase_wall_seconds = {
            p: s[1] - s[0] for p, s in self.span.items()
        }
        stats.bytes_read += self.bytes_read
        stats.bytes_written += self.bytes_written
        # executor counters (pushed by core/executor.py implementations)
        stats.device_dispatches += self.counters.get("device_dispatches", 0)
        slots = self.counters.get("batch_slots", 0)
        if slots:
            stats.batch_occupancy = (
                self.counters.get("batch_records", 0) / slots
            )
        stats.jit_compiles += self.counters.get("jit_compiles", 0)


class _PhaseTimer:
    def __init__(self, clock: PhaseClock, phase: str):
        self.clock, self.phase = clock, phase
        self._discarded = False

    def discard(self) -> None:
        """Drop this interval (e.g. an idle poll that did no phase work) —
        otherwise empty polls would stretch the phase's wall span."""
        self._discarded = True

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if not self._discarded:
            self.clock._record(self.phase, self.t0, time.perf_counter())


@dataclasses.dataclass
class ServeStats:
    """Instrumentation for one server lifetime — the serving sibling of
    :class:`SortStats` (DESIGN.md §14).

    Scheduler health: ``queue_depth_*`` sample the admission queue at
    every batch formation, ``batch_occupancy`` is the mean fraction of
    the ``max_batch`` window each dispatched batch filled, and
    ``n_shed`` counts admission-control rejections (the typed
    ``Overloaded`` path — under open-loop overload this climbs while
    p99 stays bounded).  Cache health: hit/miss/eviction counters plus
    resident bytes of the partition-block LRU.  ``latencies_s`` is the
    bounded :class:`LatencyReservoir` over submit→complete spans.
    """

    n_point: int = 0
    n_range: int = 0
    n_shed: int = 0
    n_batches: int = 0
    batch_slot_limit: int = 0  # the scheduler's max_batch
    batched_requests: int = 0  # requests dispatched through batches
    queue_depth_sum: int = 0
    queue_depth_peak: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    cache_evictions: int = 0
    cache_bytes: int = 0
    latencies_s: LatencyReservoir = dataclasses.field(
        default_factory=LatencyReservoir
    )
    wall_seconds: float = 0.0

    @property
    def n_queries(self) -> int:
        return self.n_point + self.n_range

    @property
    def batch_occupancy(self) -> float:
        slots = self.n_batches * self.batch_slot_limit
        return self.batched_requests / slots if slots else 0.0

    @property
    def mean_queue_depth(self) -> float:
        return self.queue_depth_sum / self.n_batches if self.n_batches else 0.0

    @property
    def cache_hit_rate(self) -> float:
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0

    @property
    def qps(self) -> float:
        return self.n_queries / max(self.wall_seconds, 1e-9)

    def latency_ms(self, pct: float) -> float:
        return self.latencies_s.percentile(pct) * 1e3

    def as_dict(self) -> dict:
        """JSON-friendly snapshot (the server's ``stats`` op and the
        open-loop benchmark rows)."""
        return {
            "n_point": self.n_point,
            "n_range": self.n_range,
            "n_shed": self.n_shed,
            "n_batches": self.n_batches,
            "batch_occupancy": self.batch_occupancy,
            "mean_queue_depth": self.mean_queue_depth,
            "queue_depth_peak": self.queue_depth_peak,
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "cache_evictions": self.cache_evictions,
            "cache_bytes": self.cache_bytes,
            "cache_hit_rate": self.cache_hit_rate,
            "qps": self.qps,
            "p50_ms": self.latency_ms(50),
            "p99_ms": self.latency_ms(99),
            "wall_seconds": self.wall_seconds,
        }

    def summary(self) -> str:
        return (
            f"{self.n_queries} served ({self.n_point} point / "
            f"{self.n_range} range), {self.n_shed} shed, "
            f"{self.n_batches} batches (occupancy "
            f"{self.batch_occupancy:.2f}, mean depth "
            f"{self.mean_queue_depth:.1f}, peak {self.queue_depth_peak}); "
            f"cache {self.cache_hits}/{self.cache_hits + self.cache_misses} "
            f"hits; p50 {self.latency_ms(50):.3f}ms "
            f"p99 {self.latency_ms(99):.3f}ms"
        )
