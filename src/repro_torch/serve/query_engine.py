"""Batched query execution over a
:class:`repro_torch.serve.index.SortedFileIndex` (port of
``src/repro/serve/query_engine.py``).

This is the serving analogue of the sort runtime (DESIGN.md §7): where
``core/pipeline.py`` stages Sample→Train→Partition→Sort→Write, the query
engine stages

    predict  — one vectorized RMI position prediction per key batch
               (the RMI kernel on a CUDA index; on a CPU index NumPy
               f64 by default, the kernel's plain version with
               ``use_kernels=True``),
    search   — per-key bounded last-mile binary search in the error band
               (partition-boundary fallback on a provable miss),
    scan     — range materialization, fanned out over a bounded worker
               pool so concurrent scans overlap their page-cache misses.

``QueryStats`` mirrors ``SortStats``: per-phase busy seconds, end-to-end
wall seconds, and per-query latency percentiles / throughput.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from repro_torch.core.stages.stats import LatencyReservoir
from repro_torch.serve.index import SortedFileIndex


@dataclasses.dataclass
class QueryStats:
    """Instrumentation for one query workload (the serving ``SortStats``).

    ``latencies_s`` is a bounded :class:`LatencyReservoir` (log-bucket
    sketch, ±1 bucket percentile accuracy) rather than the historical
    per-query float list — a long-lived server serves millions of
    queries per engine and must not grow memory with traffic."""

    n_point: int = 0
    n_range: int = 0
    n_hits: int = 0
    records_scanned: int = 0
    band_hits: int = 0
    fallbacks: int = 0
    phase_seconds: dict = dataclasses.field(default_factory=dict)
    latencies_s: LatencyReservoir = dataclasses.field(
        default_factory=LatencyReservoir
    )
    wall_seconds: float = 0.0

    @property
    def n_queries(self) -> int:
        return self.n_point + self.n_range

    @property
    def total_seconds(self) -> float:
        return sum(self.phase_seconds.values())

    @property
    def qps(self) -> float:
        return self.n_queries / max(self.wall_seconds, 1e-9)

    def latency_ms(self, pct: float) -> float:
        return self.latencies_s.percentile(pct) * 1e3

    def summary(self) -> str:
        return (
            f"{self.n_queries} queries ({self.n_point} point / "
            f"{self.n_range} range) in {self.wall_seconds:.3f}s = "
            f"{self.qps:.0f} q/s; p50 {self.latency_ms(50):.3f}ms "
            f"p99 {self.latency_ms(99):.3f}ms; hits {self.n_hits}, "
            f"band hits {self.band_hits}, fallbacks {self.fallbacks}, "
            f"{self.records_scanned} records scanned"
        )


class QueryEngine:
    """Point/range query execution with batching + a bounded scan pool."""

    def __init__(
        self,
        index: SortedFileIndex,
        *,
        n_workers: int = 4,
        use_kernels: bool = False,
        close_index: bool = False,
    ):
        self.index = index
        self.use_kernels = use_kernels
        self._close_index = close_index
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, n_workers), thread_name_prefix="elsar-scan"
        )
        self.stats = QueryStats()
        self._lock = threading.Lock()  # scan workers update stats too
        # the index may be shared across engines: report per-engine deltas
        self._band_hits0 = index.band_hits
        self._fallbacks0 = index.fallbacks
        self._t0 = time.perf_counter()

    # -- lifecycle -----------------------------------------------------

    def close(self) -> None:
        """Deterministic teardown: join the scan workers, freeze the
        stats, and (with ``close_index=True``) release the index's mmap
        — a long-lived server reopens manifests on compaction and must
        not rely on GC for either."""
        self._pool.shutdown(wait=True)
        self._finish()
        if self._close_index:
            self.index.close()

    def __enter__(self) -> "QueryEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _finish(self) -> None:
        self.stats.wall_seconds = time.perf_counter() - self._t0
        self.stats.band_hits = self.index.band_hits - self._band_hits0
        self.stats.fallbacks = self.index.fallbacks - self._fallbacks0

    def _phase(self, name: str, dt: float) -> None:
        with self._lock:
            self.stats.phase_seconds[name] = (
                self.stats.phase_seconds.get(name, 0.0) + dt
            )

    # -- point lookups -------------------------------------------------

    def point(self, keys: np.ndarray):
        """Batched point lookup: (B, key_width) u8 padded keys ->
        (records, rows, found).

        ``records`` holds the first-match record per query: a
        (B, record_bytes) array (zero rows where ``found`` is False) for
        fixed layouts, a list of ``bytes | None`` for line layouts.
        """
        b = keys.shape[0]
        t0 = time.perf_counter()
        preds = self.index.predict_positions(keys, use_kernels=self.use_kernels)
        t1 = time.perf_counter()
        rows = np.empty(b, dtype=np.int64)
        found = np.zeros(b, dtype=bool)
        kw = self.index.key_width
        for i in range(b):
            q = keys[i, :kw].tobytes()
            r = self.index._bound(q, int(preds[i]), "left")
            rows[i] = r
            found[i] = r < self.index.n and self.index._key_at(r) == q
        t2 = time.perf_counter()
        out = self.index.fetch_rows(rows, found)
        self._phase("predict", t1 - t0)
        self._phase("search", t2 - t1)
        self.stats.n_point += b
        self.stats.n_hits += int(found.sum())
        self.stats.latencies_s.extend([(t2 - t0) / b] * b)
        return out, rows, found

    # -- range scans ---------------------------------------------------

    def _scan_one(self, lo_key: bytes, hi_key: bytes):
        t0 = time.perf_counter()
        start, stop = self.index.range_bounds(lo_key, hi_key)
        out = np.array(self.index.materialize(start, stop))
        dt = time.perf_counter() - t0
        self._phase("scan", dt)
        with self._lock:
            self.stats.latencies_s.append(dt)
            self.stats.records_scanned += stop - start
        return out, stop - start

    def range(self, ranges: "list[tuple[bytes, bytes]]") -> list:
        """Concurrent inclusive range scans through the bounded pool.

        Each result is the materialized record span — an (m, record_bytes)
        array for fixed layouts, a 1-D byte array of the concatenated
        lines for line layouts.
        """
        futures = [
            self._pool.submit(self._scan_one, lo, hi) for lo, hi in ranges
        ]
        results = [f.result() for f in futures]
        self.stats.n_range += len(ranges)
        self.stats.n_hits += sum(1 for _, m in results if m)
        return [out for out, _ in results]
