"""Instrumentation for the pipelined runtime: ``SortStats`` + ``PhaseClock``.

Copy of ``src/repro/core/stages/stats.py`` for the PyTorch port.

``SortStats`` is the per-sort instrumentation record every entry point
returns; ``PhaseClock`` is the thread-safe accumulator the stage workers
share while a sort is in flight (``repro_torch.core.pipeline`` and
``repro_torch.core.external`` re-export ``SortStats``).
"""

from __future__ import annotations

import dataclasses
import threading
import time

from repro_torch.data import gensort


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
    phase_cpu_seconds: dict = dataclasses.field(default_factory=dict)
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
    summed per phase, wall spans are merged (min start / max end), and
    thread CPU time is accumulated via ``time.thread_time``.  Integer
    event counters (device dispatches, batch slots, ...) accumulate via
    ``add_counter`` and land in ``finish``.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self.busy: dict[str, float] = {}
        self.cpu: dict[str, float] = {}
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

    def _record(self, phase: str, t0: float, t1: float, cpu_dt: float) -> None:
        with self._lock:
            self.busy[phase] = self.busy.get(phase, 0.0) + (t1 - t0)
            self.cpu[phase] = self.cpu.get(phase, 0.0) + cpu_dt
            span = self.span.setdefault(phase, [t0, t1])
            span[0] = min(span[0], t0)
            span[1] = max(span[1], t1)

    def finish(self, stats: SortStats) -> None:
        stats.wall_seconds = time.perf_counter() - self._t0
        stats.phase_seconds = dict(self.busy)
        stats.phase_cpu_seconds = dict(self.cpu)
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
        self.c0 = time.thread_time()
        return self

    def __exit__(self, *exc):
        if not self._discarded:
            self.clock._record(
                self.phase,
                self.t0,
                time.perf_counter(),
                time.thread_time() - self.c0,
            )
