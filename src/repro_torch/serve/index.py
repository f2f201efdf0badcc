"""Learned-index query serving over sorted ELSAR output (port of
``src/repro/serve/index.py``; DESIGN.md §7, §8).

A sorted ELSAR file is a concatenation of monotone equi-depth partitions,
so the CDF model that produced it is already a learned index over it:
``floor(F(key) * n)`` predicts a record's row to within the manifest's
measured error band.  :class:`SortedFileIndex` mmaps the sorted file and
answers point lookups and range scans with

1. a vectorized RMI position prediction for the whole key batch,
2. a bounded **last-mile binary search** inside the error-band window
   around each prediction (one contiguous window read per query), and
3. a **partition-boundary fallback** when the window provably missed:
   the manifest's boundary keys narrow the answer to one partition span,
   which is then bisected with O(log) single-record mmap probes.

Step 2's result is trusted only when it is provably the *global* answer
(strictly inside the window, or bracketed by the window's outer
neighbors), so a too-small error band degrades latency, never
correctness.

The index serves both record layouts (``repro_torch.core.format``): fixed
gensort files address record *i* by stride, line files through the
manifest's **offsets sidecar** — no delimiter rescans at query time.
All comparisons are memcmp on the format's zero-padded key window
(``key_width`` bytes) — byte-identical to the sorter's own order,
including ties beyond the 8-byte numeric embedding.

Step 1 runs where the index lives (``device``).  On a CUDA device it
always runs the RMI kernel (``kernels/ops.rmi_predict_pos``), on the
manifest's model uploaded once at open; keys are encoded on the host,
as the reference does.  On the CPU, ``use_kernels=True`` runs the
kernel's plain version and ``use_kernels=False`` the NumPy float64
predictor, as in the reference.  Steps 2 and 3 read the mmap on the host.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.core import encoding, manifest as manifest_lib, rmi
from repro_torch.core.executor import resolve_device
from repro_torch.core.format import line_keys
from repro_torch.kernels import ops


class _ClosedBlock:
    """Post-``close()`` placeholder: any record access fails loudly
    instead of reading through a released mmap."""

    def __getattr__(self, name):
        raise ValueError("SortedFileIndex is closed")

    def close(self) -> None:
        pass


class SortedFileIndex:
    """Point/range queries over one sorted record file + its manifest."""

    def __init__(
        self,
        sorted_path: str,
        manifest: manifest_lib.SortManifest,
        *,
        device="cuda",
    ):
        self.path = sorted_path
        self.manifest = manifest
        self.device = resolve_device(device)
        # the model where the predictions run, uploaded once
        self._model = manifest.model.to(self.device)
        self.fmt = manifest.fmt
        self.key_width = self.fmt.key_width
        self._kdt = f"S{self.key_width}"
        if self.fmt.kind == "line":
            if manifest.line_offsets is None:
                raise ValueError(
                    f"line-format manifest for {sorted_path!r} lacks the "
                    f"offsets sidecar — re-emit it (stale or hand-built?)"
                )
            # read_block validates offsets[-1] == file size (stale check)
            self._block = self.fmt.read_block(
                sorted_path, offsets=manifest.line_offsets
            )
            self.records = None  # no fixed-stride matrix view exists
        else:
            self._block = self.fmt.read_block(sorted_path)
            self.records = self._block.data.reshape(
                -1, self.fmt.record_bytes
            )
        self.n = self._block.n_records
        if self.n != manifest.n_records:
            raise ValueError(
                f"{sorted_path!r} holds {self.n} records but its manifest "
                f"says {manifest.n_records} — stale sidecar?"
            )
        # (P,) |S{K}| boundary keys + (P+1,) record starts for the fallback
        self._bounds = np.ascontiguousarray(manifest.boundary_keys).view(
            [("k", self._kdt)]
        )["k"].reshape(-1)
        self._starts = manifest.part_starts()
        # serving counters (read by QueryStats); QueryEngine's scan pool
        # calls _bound from worker threads, so increments take a lock
        self.band_hits = 0
        self.fallbacks = 0
        # observed last-mile distances: max(pred - answer) and
        # max(answer - pred) over every bound served.  The manifest's
        # (err_lo, err_hi) claims to bound these; tests on adversarial
        # corpora assert observed_err_* never exceeds the band — a
        # silent band underestimation shows up here, not as a wrong
        # answer (the fallback keeps correctness).
        self.observed_err_lo = 0
        self.observed_err_hi = 0
        self._stat_lock = threading.Lock()

    @classmethod
    def open(
        cls,
        sorted_path: str,
        manifest_path: str | None = None,
        *,
        device="cuda",
    ) -> "SortedFileIndex":
        """Attach to a sorted file; loads ``<path>.manifest.npz`` by default."""
        mpath = manifest_path or manifest_lib.manifest_path(sorted_path)
        return cls(sorted_path, manifest_lib.load(mpath), device=device)

    # -- lifecycle -----------------------------------------------------

    @property
    def closed(self) -> bool:
        return isinstance(self._block, _ClosedBlock)

    def close(self) -> None:
        """Release the mmap deterministically.  A long-lived server
        reopens manifests on compaction; without an explicit close the
        old file's pages and descriptor lived until GC.  Idempotent;
        any query touching record data after close raises
        ``ValueError``."""
        blk, self._block = self._block, _ClosedBlock()
        self.records = None
        if not isinstance(blk, _ClosedBlock):
            blk.close()

    def __enter__(self) -> "SortedFileIndex":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- key plumbing --------------------------------------------------

    def pad_key(self, raw: bytes) -> bytes:
        """Zero-pad/truncate a raw key (e.g. line content) to the
        format's key window — the form every query key must take."""
        return raw[: self.key_width].ljust(self.key_width, b"\x00")

    def min_key(self) -> bytes:
        """Padded key of the first record (b"" when empty) — the shard
        routing key of ``serve/router.ShardRouter``."""
        return self._key_at(0) if self.n else b""

    def max_key(self) -> bytes:
        """Padded key of the last record (b"" when empty)."""
        return self._key_at(self.n - 1) if self.n else b""

    def _key_at(self, i: int) -> bytes:
        if self.records is not None:
            return self.records[i, : self.key_width].tobytes()
        off = self._block.offsets
        raw = self._block.data[off[i] : off[i + 1] - 1].tobytes()
        return self.pad_key(raw)

    def keys_at(self, rows: np.ndarray) -> np.ndarray:
        """(m, key_width) u8 padded keys of the given rows — the batch
        form every query entry point accepts (workload generators)."""
        rows = np.asarray(rows, dtype=np.int64)
        if self.records is not None:
            return np.array(self.records[rows, : self.key_width])
        # line layout: one vectorized gather over the picked rows'
        # content spans (same masked-position trick as format.line_keys,
        # which needs consecutive offsets and so can't take a row pick)
        off = self._block.offsets
        starts = off[rows]
        lens = np.minimum(off[rows + 1] - 1 - starts, self.key_width)
        cols = np.arange(self.key_width, dtype=np.int64)
        valid = cols[None, :] < lens[:, None]
        pos = np.minimum(
            starts[:, None] + cols[None, :],
            max(int(self._block.data.shape[0]) - 1, 0),
        )
        return np.where(
            valid, np.asarray(self._block.data)[pos], np.uint8(0)
        ).astype(np.uint8, copy=False)

    def _keys_window(self, a: int, b: int) -> np.ndarray:
        """Contiguous |S{K}| array of the padded keys of rows [a, b)."""
        if self.records is not None:
            keys = np.ascontiguousarray(self.records[a:b, : self.key_width])
        else:
            keys = line_keys(
                self._block.data, self._block.offsets[a : b + 1],
                self.key_width,
            )
        return keys.view([("k", self._kdt)])["k"].reshape(-1)

    # -- prediction ----------------------------------------------------

    def predict_positions(
        self, keys: np.ndarray, *, use_kernels: bool = False
    ) -> np.ndarray:
        """(B, K) u8 keys -> (B,) int64 predicted rows (vectorized RMI).
        A CUDA index always runs the RMI kernel; a CPU index runs its
        plain version under ``use_kernels``, else the NumPy predictor."""
        hi, lo = encoding.encode_np(keys)
        if self.device.type == "cuda" or use_kernels:
            if self.n == 0:  # no rows: the reference's clip(0, 0, -1)
                return np.full(keys.shape[0], -1, dtype=np.int64)
            hi_t, lo_t = (
                torch.from_numpy(w.astype(np.int64)).to(self.device)
                for w in (hi, lo)
            )
            pos = ops.rmi_predict_pos(self._model, hi_t, lo_t, self.n)
            return np.clip(pos.cpu().numpy().astype(np.int64), 0, self.n - 1)
        cdf = rmi.predict_cdf_np(self.manifest.model, hi, lo)
        return np.clip(
            (cdf.astype(np.float64) * self.n).astype(np.int64), 0, self.n - 1
        )

    # -- search primitives ---------------------------------------------

    def _banded(self, q: bytes, pred: int, side: str) -> int | None:
        """searchsorted(q, side) inside the error-band window, or None
        when the window result is not provably the global answer."""
        m = self.manifest
        a = max(0, int(pred) - m.err_lo)
        b = min(self.n, int(pred) + m.err_hi + 1)
        win = self._keys_window(a, b)
        r = a + int(np.searchsorted(win, q, side=side))
        if r == a and a > 0:
            prev = self._key_at(a - 1)
            if not (prev < q if side == "left" else prev <= q):
                return None
        if r == b and b < self.n:
            nxt = self._key_at(b)
            if not (nxt >= q if side == "left" else nxt > q):
                return None
        return r

    def _fallback(self, q: bytes, side: str) -> int:
        """Partition-boundary search: boundary keys pin the answer to one
        partition span, bisected with single-record mmap probes."""
        j = int(np.searchsorted(self._bounds, q, side=side))
        lo = int(self._starts[max(j - 1, 0)])
        hi = int(self._starts[min(j, self.manifest.n_partitions)])
        while lo < hi:
            mid = (lo + hi) // 2
            k = self._key_at(mid)
            if k < q or (side == "right" and k == q):
                lo = mid + 1
            else:
                hi = mid
        return lo

    def _bound(self, q: bytes, pred: int, side: str) -> int:
        r = self._banded(q, pred, side)
        if r is None:
            with self._stat_lock:
                self.fallbacks += 1
            r = self._fallback(q, side)
        else:
            with self._stat_lock:
                self.band_hits += 1
        with self._stat_lock:
            self.observed_err_lo = max(self.observed_err_lo, pred - r)
            self.observed_err_hi = max(self.observed_err_hi, r - pred)
        return r

    def lower_bound(self, key: bytes, pred: int | None = None) -> int:
        """First row with record key >= ``key`` (n when past the end)."""
        if pred is None:
            pred = int(self.predict_positions(self._as_batch(key))[0])
        return self._bound(self.pad_key(key), pred, "left")

    def upper_bound(self, key: bytes, pred: int | None = None) -> int:
        """First row with record key > ``key``."""
        if pred is None:
            pred = int(self.predict_positions(self._as_batch(key))[0])
        return self._bound(self.pad_key(key), pred, "right")

    def _as_batch(self, key: bytes) -> np.ndarray:
        return np.frombuffer(self.pad_key(key), dtype=np.uint8)[None, :]

    # -- record materialization ----------------------------------------

    def record_at(self, i: int) -> bytes:
        """Raw bytes of record ``i`` (line records keep their delimiter)."""
        return self._block.record(i)

    def materialize(self, start: int, stop: int):
        """Records ``[start, stop)``: an (m, record_bytes) view for fixed
        layouts, a contiguous 1-D byte view for line layouts."""
        if self.records is not None:
            return self.records[start:stop]
        off = self._block.offsets
        return self._block.data[off[start] : off[stop]]

    def fetch_rows(self, rows: np.ndarray, found: np.ndarray):
        """First-match records for a point-lookup result: an
        (B, record_bytes) array (zeros where absent) for fixed layouts,
        a list of ``bytes | None`` for line layouts."""
        if self.records is not None:
            out = np.zeros(
                (rows.shape[0], self.fmt.record_bytes), dtype=np.uint8
            )
            if found.any():
                out[found] = self.records[rows[found]]
            return out
        return [
            self.record_at(int(r)) if f else None
            for r, f in zip(rows, found)
        ]

    # -- queries -------------------------------------------------------

    def lookup(
        self, keys: np.ndarray, *, use_kernels: bool = False
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched point lookup of (B, key_width) u8 padded keys.

        Returns ``(rows, found)``: the row of the *first* record matching
        each key (lower bound when absent) and a boolean hit mask.
        """
        preds = self.predict_positions(keys, use_kernels=use_kernels)
        rows = np.empty(keys.shape[0], dtype=np.int64)
        found = np.zeros(keys.shape[0], dtype=bool)
        for i in range(keys.shape[0]):
            q = keys[i, : self.key_width].tobytes()
            r = self._bound(q, int(preds[i]), "left")
            rows[i] = r
            found[i] = r < self.n and self._key_at(r) == q
        return rows, found

    def range_bounds(self, lo_key: bytes, hi_key: bytes) -> tuple[int, int]:
        """Row span [start, stop) of keys in the inclusive range
        ``[lo_key, hi_key]``."""
        preds = self.predict_positions(
            np.stack([self._as_batch(lo_key)[0], self._as_batch(hi_key)[0]])
        )
        start = self._bound(self.pad_key(lo_key), int(preds[0]), "left")
        stop = self._bound(self.pad_key(hi_key), int(preds[1]), "right")
        return start, max(stop, start)

    def range_scan(self, lo_key: bytes, hi_key: bytes):
        """All records with ``lo_key <= key <= hi_key`` (mmap-backed view;
        see :meth:`materialize` for the per-format shape)."""
        start, stop = self.range_bounds(lo_key, hi_key)
        return self.materialize(start, stop)
