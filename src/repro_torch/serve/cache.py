"""LRU hot partition-block cache in front of the mmap scan path (copy of
``src/repro/serve/cache.py``; DESIGN.md §14).

The sorted file is a concatenation of equi-depth partitions and the
manifest knows every partition's record span, so the natural cache unit
is one **partition block**: the materialized bytes of partition ``j``.
Point fetches and range scans that land in a hot partition are served
from the resident copy instead of faulting mmap pages — the serving
analogue of rtp-llm's KV block cache, with the partition id playing the
block id.

Keys are ``(path, model_hash, partition_id)``.  ``model_hash`` is the
manifest-v3 sha256 of the model arrays: a recompacted/re-sorted file
gets a new manifest hash, so stale blocks can never serve a reopened
index — they simply miss and age out of the LRU (or are dropped eagerly
via :meth:`invalidate`).  Byte-identity with the uncached path is a
test invariant, not a best effort: blocks are copies of exactly what
``SortedFileIndex.materialize`` returns.
"""

from __future__ import annotations

import collections
import threading

import numpy as np

from repro_torch.core.stages.stats import ServeStats


class _Block:
    """One resident partition: records ``[start, stop)`` of the file."""

    __slots__ = ("start", "stop", "data", "offsets", "nbytes")

    def __init__(self, start: int, stop: int, data, offsets):
        self.start = start
        self.stop = stop
        self.data = data  # fixed: (m, R) u8; line: (bytes,) u8
        self.offsets = offsets  # line layouts: (m + 1,) rebased starts
        self.nbytes = int(data.nbytes) + (
            int(offsets.nbytes) if offsets is not None else 0
        )


class PartitionBlockCache:
    """Bounded LRU over materialized partition blocks.

    Thread-safe: the server's batch loop runs on a worker thread while
    ``invalidate`` may be called from the event loop on manifest
    reload.  Counters land on the shared :class:`ServeStats`.
    """

    def __init__(
        self,
        capacity_bytes: int = 64 << 20,
        *,
        stats: "ServeStats | None" = None,
    ):
        self.capacity_bytes = int(capacity_bytes)
        self.stats = stats if stats is not None else ServeStats()
        self._lock = threading.Lock()
        self._blocks: "collections.OrderedDict[tuple, _Block]" = (
            collections.OrderedDict()
        )

    # -- core lookup ---------------------------------------------------

    def _load_block(self, index, pid: int) -> _Block:
        starts = index.manifest.part_starts()
        a, b = int(starts[pid]), int(starts[pid + 1])
        if index.records is not None:
            data = np.array(index.records[a:b])  # owned copy off the mmap
            return _Block(a, b, data, None)
        off = index._block.offsets
        data = np.array(index._block.data[off[a] : off[b]])
        rebased = np.asarray(off[a : b + 1], dtype=np.int64) - int(off[a])
        return _Block(a, b, data, rebased)

    def get_block(self, index, pid: int) -> _Block:
        """The resident block for partition ``pid`` (loading + possibly
        evicting on miss)."""
        key = (index.path, index.manifest.model_hash, int(pid))
        with self._lock:
            blk = self._blocks.get(key)
            if blk is not None:
                self._blocks.move_to_end(key)
                self.stats.cache_hits += 1
                return blk
            self.stats.cache_misses += 1
        blk = self._load_block(index, int(pid))
        with self._lock:
            if blk.nbytes <= self.capacity_bytes:
                self._blocks[key] = blk
                self.stats.cache_bytes += blk.nbytes
                while self.stats.cache_bytes > self.capacity_bytes:
                    _, old = self._blocks.popitem(last=False)
                    self.stats.cache_bytes -= old.nbytes
                    self.stats.cache_evictions += 1
            # an over-capacity block bypasses the cache (served once)
        return blk

    # -- serving surfaces (byte-identical to the uncached paths) -------

    def _pid_of_rows(self, index, rows: np.ndarray) -> np.ndarray:
        starts = index.manifest.part_starts()
        return np.searchsorted(starts, rows, side="right") - 1

    def fetch_rows(self, index, rows: np.ndarray, found: np.ndarray):
        """Cache-fronted ``SortedFileIndex.fetch_rows``: first-match
        records per point query, zeros/None where absent."""
        rows = np.asarray(rows, dtype=np.int64)
        pids = self._pid_of_rows(index, np.clip(rows, 0, index.n - 1))
        if index.records is not None:
            out = np.zeros(
                (rows.shape[0], index.fmt.record_bytes), dtype=np.uint8
            )
            for i in range(rows.shape[0]):
                if found[i]:
                    blk = self.get_block(index, pids[i])
                    out[i] = blk.data[rows[i] - blk.start]
            return out
        result = []
        for i in range(rows.shape[0]):
            if not found[i]:
                result.append(None)
                continue
            blk = self.get_block(index, pids[i])
            r = int(rows[i] - blk.start)
            result.append(
                blk.data[blk.offsets[r] : blk.offsets[r + 1]].tobytes()
            )
        return result

    def materialize(self, index, start: int, stop: int):
        """Cache-fronted ``SortedFileIndex.materialize``: records
        ``[start, stop)`` assembled from the covering partition blocks
        (a range may span several)."""
        if stop <= start:
            return index.materialize(start, start)  # canonical empty
        starts = index.manifest.part_starts()
        p_lo = int(np.searchsorted(starts, start, side="right") - 1)
        p_hi = int(np.searchsorted(starts, stop - 1, side="right") - 1)
        pieces = []
        for pid in range(p_lo, p_hi + 1):
            blk = self.get_block(index, pid)
            a = max(start, blk.start) - blk.start
            b = min(stop, blk.stop) - blk.start
            if index.records is not None:
                pieces.append(blk.data[a:b])
            else:
                pieces.append(
                    blk.data[blk.offsets[a] : blk.offsets[b]]
                )
        return pieces[0] if len(pieces) == 1 else np.concatenate(pieces)

    # -- invalidation --------------------------------------------------

    def invalidate(
        self,
        *,
        model_hash: "str | None" = None,
        path: "str | None" = None,
    ) -> int:
        """Eagerly drop blocks by manifest hash and/or path (compaction
        replaced the file).  No filter = drop everything."""
        dropped = 0
        with self._lock:
            for key in list(self._blocks):
                k_path, k_hash, _ = key
                if model_hash is not None and k_hash != model_hash:
                    continue
                if path is not None and k_path != path:
                    continue
                self.stats.cache_bytes -= self._blocks.pop(key).nbytes
                dropped += 1
        return dropped
