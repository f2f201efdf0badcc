"""Record-format layer: the seam between byte layout and the sort core

Copy of ``src/repro/core/format.py`` for the PyTorch port.
(DESIGN.md §8).

The learned-sort core is layout-agnostic — it partitions and orders
fixed-width *key prefixes* and permutation indices; only I/O and key
extraction depend on how records sit in the file.  This module makes
that seam explicit:

* :class:`FixedFormat` — fixed-stride records (the gensort layout the
  paper benchmarks on: 100-byte records, 10-byte keys).  Reproduces the
  historical pipeline byte-for-byte.
* :class:`LineFormat` — variable-length delimiter-terminated ASCII
  records (newline-delimited text, the GNU ``sort`` workload).  Records
  are addressed through an **offsets array**; keys are the first
  ``max_key_bytes`` of the line content, zero-padded — memcmp on that
  padded window matches ``LC_ALL=C sort`` order for printable content
  whenever the window covers the longest line, and ties beyond the
  window stay in input order (stable).

Both formats produce/consume :class:`RecordBlock` — ``(data, offsets,
keys)`` — which is the only record representation the pipeline, the
validator, the manifest, and the serving index ever touch:

* ``data``    — the records' raw bytes, concatenated back-to-back
  (line records keep their trailing delimiter; a final unterminated
  line is normalized by appending one, as GNU sort does),
* ``offsets`` — ``(n + 1,)`` int64 record-start offsets into ``data``,
* ``keys``    — ``(n, key_width)`` uint8 fixed-width key prefixes, the
  array the encoder/RMI/LearnedSort operate on.

Striping for the parallel reader pool is a pure function of the file
(record count for fixed, byte size for lines) and the stripe count —
never of thread timing — which is what keeps sorted output
byte-identical at any ``n_readers``.  Line stripes are byte ranges
whose ownership rule ("a stripe owns the records that *start* inside
it") splits fragments on delimiter boundaries, not fixed strides.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Union

import numpy as np

from repro_torch.data.pipeline import Stripe, byte_stripes, record_stripes

# Chunk size for streaming delimiter scans (bounds reader memory).
_SCAN_CHUNK = 8 << 20


# ---------------------------------------------------------------------------
# RecordBlock: the (data, offsets, keys) representation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RecordBlock:
    """A batch of records as raw bytes + offsets + key-prefix matrix."""

    data: np.ndarray  # (n_bytes,) uint8, records concatenated
    offsets: np.ndarray  # (n + 1,) int64 record starts into ``data``
    keys: np.ndarray  # (n, key_width) uint8 zero-padded key prefixes

    @property
    def n_records(self) -> int:
        return int(self.offsets.shape[0] - 1)

    @property
    def n_bytes(self) -> int:
        return int(self.offsets[-1])

    def record(self, i: int) -> bytes:
        return self.data[self.offsets[i] : self.offsets[i + 1]].tobytes()

    def close(self) -> None:
        """Release the backing mmap (no-op for owned in-memory blocks).

        Long-lived servers (``serve/index.SortedFileIndex``) reopen
        manifests on compaction; without this the old file's pages and
        descriptor lived until GC.  Every array field is replaced by an
        empty placeholder first so the mmap's buffer has no exports
        left; a still-borrowed view elsewhere degrades to GC-time
        release rather than an error."""
        data, keys = self.data, self.keys
        kw = keys.shape[1] if keys.ndim == 2 else 0
        self.data = np.empty(0, np.uint8)
        self.offsets = np.zeros(1, np.int64)
        self.keys = np.empty((0, kw), np.uint8)
        mm, arr = None, data
        while arr is not None and mm is None:  # walk the view chain
            mm = getattr(arr, "_mmap", None)
            arr = getattr(arr, "base", None)
        del data, keys, arr
        if mm is not None:
            try:
                mm.close()
            except BufferError:  # a caller still holds a view
                pass

    def slice_bytes(self, lo: int, hi: int) -> bytes:
        """Raw bytes of records ``[lo, hi)`` — contiguous by construction."""
        return self.data[self.offsets[lo] : self.offsets[hi]].tobytes()

    def slice_records(self, lo: int, hi: int) -> "RecordBlock":
        """Records ``[lo, hi)`` as a sub-block.  ``data`` stays a view of
        this block's buffer (mmap-backed blocks never copy here), offsets
        are rebased to the sub-block — the chunk iterator of the
        distributed sorter (``core/terasort.py``)."""
        off = np.asarray(self.offsets[lo : hi + 1], dtype=np.int64)
        base = int(off[0])
        return RecordBlock(
            self.data[base : int(off[-1])], off - base, self.keys[lo:hi]
        )

    def tobytes(self) -> bytes:
        return self.data[: self.offsets[-1]].tobytes()

    def memview(self) -> memoryview:
        """Zero-copy buffer of the records' bytes — the writer pool's
        currency (DESIGN.md §15).  A view over ``data``, not a
        ``tobytes()`` copy; copies only if the underlying array is
        non-contiguous (never the case for pipeline-produced blocks)."""
        d = self.data[: self.offsets[-1]]
        if not d.flags.c_contiguous:
            d = np.ascontiguousarray(d)
        return memoryview(d).cast("B")

    def gather_bytes(self, rows: np.ndarray) -> bytes:
        """Raw bytes of the records ``rows`` (any subset, in the given
        order), concatenated — the spill writer of the distributed
        sorter.  Unlike :meth:`take`, ``rows`` need not be a full
        permutation."""
        rows = np.asarray(rows, dtype=np.int64)
        lengths = np.diff(self.offsets)
        n = self.n_records
        if n and (lengths == lengths[0]).all():
            r = int(lengths[0])
            return np.ascontiguousarray(
                self.data[: n * r].reshape(n, r)[rows]
            ).tobytes()
        sel = lengths[rows]
        new_off = np.concatenate(
            [np.zeros(1, np.int64), np.cumsum(sel, dtype=np.int64)]
        )
        shift = self.offsets[:-1][rows] - new_off[:-1]
        idx = np.repeat(shift, sel) + np.arange(new_off[-1], dtype=np.int64)
        return np.ascontiguousarray(self.data)[idx].tobytes()

    def take(self, perm: np.ndarray) -> "RecordBlock":
        """Records reordered by ``perm`` (output row i = input row perm[i])."""
        n = self.n_records
        lengths = np.diff(self.offsets)
        if n and (lengths == lengths[0]).all():
            # fixed-stride fast path: one reshape + fancy index
            r = int(lengths[0])
            data = np.ascontiguousarray(
                self.data[: n * r].reshape(n, r)[perm]
            ).reshape(-1)
            return RecordBlock(data, self.offsets.copy(), self.keys[perm])
        new_len = lengths[perm]
        new_off = np.concatenate(
            [np.zeros(1, np.int64), np.cumsum(new_len, dtype=np.int64)]
        )
        # output byte p of record i reads input byte src_start[i] + (p -
        # dst_start[i]): one vectorized gather over the whole block
        shift = self.offsets[:-1][perm] - new_off[:-1]
        idx = np.repeat(shift, new_len) + np.arange(new_off[-1], dtype=np.int64)
        return RecordBlock(
            np.ascontiguousarray(self.data)[idx], new_off, self.keys[perm]
        )


# ---------------------------------------------------------------------------
# Key extraction helpers
# ---------------------------------------------------------------------------


def line_keys(
    data: np.ndarray, offsets: np.ndarray, key_width: int
) -> np.ndarray:
    """(n, key_width) zero-padded key prefixes of delimiter-terminated
    records: bytes ``[start, start + min(key_width, len - 1))`` — the
    trailing delimiter is never part of the key."""
    n = offsets.shape[0] - 1
    if n == 0:
        return np.empty((0, key_width), dtype=np.uint8)
    starts = offsets[:-1]
    content_len = np.diff(offsets) - 1  # exclude the delimiter
    cols = np.arange(key_width, dtype=np.int64)
    valid = cols[None, :] < content_len[:, None]
    pos = np.minimum(starts[:, None] + cols[None, :], data.shape[0] - 1)
    return np.where(valid, data[pos], np.uint8(0)).astype(np.uint8, copy=False)


# ---------------------------------------------------------------------------
# FixedFormat
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FixedFormat:
    """Fixed-stride records: ``record_bytes`` per record, the first
    ``key_bytes`` of each being the sort key (gensort: 100/10)."""

    record_bytes: int = 100
    key_bytes: int = 10

    kind = "fixed"

    @property
    def key_width(self) -> int:
        return self.key_bytes

    # -- file geometry -------------------------------------------------

    def count_records(self, path: str) -> int:
        size = os.path.getsize(path)
        if size % self.record_bytes:
            raise ValueError(
                f"{path!r} is {size} bytes — not a multiple of "
                f"{self.record_bytes}-byte records"
            )
        return size // self.record_bytes

    def output_bytes(self, path: str) -> int:
        return self.count_records(path) * self.record_bytes

    def file_stripes(self, path: str, n_stripes: int) -> list[Stripe]:
        """Stripes in *record* units (pure function of the record count)."""
        return record_stripes(self.count_records(path), n_stripes)

    # -- block construction --------------------------------------------

    def _block_from_matrix(self, mat: np.ndarray) -> RecordBlock:
        n = mat.shape[0]
        offsets = np.arange(n + 1, dtype=np.int64) * self.record_bytes
        return RecordBlock(mat.reshape(-1), offsets, mat[:, : self.key_bytes])

    def iter_batches(self, path: str, stripe: Stripe, batch_records: int):
        """Owned, input-order blocks covering ``stripe`` (record units)."""
        recs = np.memmap(path, dtype=np.uint8, mode="r")
        recs = recs.reshape(-1, self.record_bytes)
        for off in range(stripe.start, stripe.stop, batch_records):
            hi = min(off + batch_records, stripe.stop)
            yield self._block_from_matrix(np.array(recs[off:hi]))

    def parse_blob(self, blob: bytes) -> RecordBlock:
        if len(blob) % self.record_bytes:
            raise ValueError(
                f"spill blob of {len(blob)} bytes is not a multiple of "
                f"{self.record_bytes}"
            )
        data = np.frombuffer(blob, dtype=np.uint8)
        return self._block_from_matrix(data.reshape(-1, self.record_bytes))

    def read_block(self, path: str, offsets: np.ndarray | None = None):
        """Whole-file mmap-backed block (``offsets`` accepted for API
        symmetry with :class:`LineFormat`; fixed offsets are derived)."""
        del offsets
        n = self.count_records(path)
        if n == 0:
            return RecordBlock(
                np.empty(0, np.uint8),
                np.zeros(1, np.int64),
                np.empty((0, self.key_bytes), np.uint8),
            )
        mat = np.memmap(path, dtype=np.uint8, mode="r").reshape(
            n, self.record_bytes
        )
        return self._block_from_matrix(mat)

    # -- sampling ------------------------------------------------------

    def sample_keys(
        self, path: str, n_records: int, sample_frac: float
    ) -> np.ndarray:
        """Uniform key sample, capped at 10M (paper §3.1/§6): contiguous
        runs from 64 evenly-spaced offsets, independent of the reader
        count, so every reader count trains the identical model."""
        n_stripes = 64
        take = min(
            max(int(n_records * sample_frac), 1024), 10_000_000, n_records
        )
        recs = np.memmap(path, dtype=np.uint8, mode="r").reshape(
            n_records, self.record_bytes
        )
        per_stripe = max(take // n_stripes, 16)
        rng = np.random.default_rng(0)
        keys = []
        for s in range(n_stripes):
            start = int(s * n_records / n_stripes)
            run = np.array(
                recs[start : min(start + per_stripe, n_records), : self.key_bytes]
            )
            keys.append(run)
        out = np.concatenate(keys)
        if out.shape[0] > take:
            # keep in-file order: the planner's sortedness/run-length
            # diagnostics (core/planner.py) read the sample as a proxy
            # for input order
            sel = np.sort(rng.choice(out.shape[0], take, replace=False))
            out = out[sel]
        return out

    # -- manifest serialization ---------------------------------------

    def manifest_fields(self) -> dict:
        return {
            "fmt_kind": np.array(self.kind),
            "fmt_record_bytes": np.int64(self.record_bytes),
            "fmt_key_bytes": np.int64(self.key_bytes),
        }


# ---------------------------------------------------------------------------
# LineFormat
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LineFormat:
    """Variable-length delimiter-terminated records (newline text files).

    ``max_key_bytes`` is the encoder's window: the sort key is the first
    ``max_key_bytes`` bytes of the line content, zero-padded.  Lines that
    agree on the window tie and keep input order (the sort is stable);
    choose a window at least as wide as the longest line for full
    ``LC_ALL=C sort`` order.  A final line without a trailing delimiter
    is normalized by appending one (GNU sort semantics).
    """

    max_key_bytes: int = 16
    delimiter: bytes = b"\n"

    kind = "line"

    def __post_init__(self):
        if len(self.delimiter) != 1:
            raise ValueError(
                f"delimiter must be a single byte, got {self.delimiter!r}"
            )
        if self.max_key_bytes < 1:
            raise ValueError("max_key_bytes must be >= 1")

    @property
    def key_width(self) -> int:
        return self.max_key_bytes

    @property
    def _delim(self) -> int:
        return self.delimiter[0]

    # -- file geometry -------------------------------------------------

    def output_bytes(self, path: str) -> int:
        """Output size: input size, +1 when the final line is
        unterminated (the normalization delimiter)."""
        size = os.path.getsize(path)
        if size == 0:
            return 0
        with open(path, "rb") as f:
            f.seek(-1, os.SEEK_END)
            last = f.read(1)
        return size + (0 if last == self.delimiter else 1)

    def file_stripes(self, path: str, n_stripes: int) -> list[Stripe]:
        """Stripes in *byte* units (pure function of the byte size).
        Ownership rule: a stripe owns the records that *start* inside
        its byte range, so fragments split on delimiter boundaries."""
        return byte_stripes(os.path.getsize(path), n_stripes)

    # -- delimiter scanning -------------------------------------------

    def _next_record_start(self, data: np.ndarray, pos: int) -> int:
        """First record start >= ``pos`` (record starts are 0 and every
        position after a delimiter); ``data.size`` when there is none."""
        if pos <= 0:
            return 0
        q = pos - 1
        while q < data.shape[0]:
            chunk = np.asarray(data[q : q + _SCAN_CHUNK])
            hits = np.flatnonzero(chunk == self._delim)
            if hits.size:
                return q + int(hits[0]) + 1
            q += _SCAN_CHUNK
        return data.shape[0]

    def _record_ends(self, data: np.ndarray, start: int, end: int) -> np.ndarray:
        """Absolute end offsets (exclusive, delimiter included) of every
        record in ``[start, end)``, chunked to bound memory."""
        ends = []
        pos = start
        while pos < end:
            hi = min(pos + _SCAN_CHUNK, end)
            chunk = np.asarray(data[pos:hi])
            hit = np.flatnonzero(chunk == self._delim).astype(np.int64)
            if hit.size:
                ends.append(hit + pos + 1)
            pos = hi
        if ends:
            return np.concatenate(ends)
        return np.empty(0, dtype=np.int64)

    # -- block construction --------------------------------------------

    def _block(self, data: np.ndarray, offsets: np.ndarray) -> RecordBlock:
        return RecordBlock(
            data, offsets, line_keys(data, offsets, self.max_key_bytes)
        )

    def iter_batches(self, path: str, stripe: Stripe, batch_records: int):
        """Owned, input-order blocks of the records starting in
        ``stripe`` (byte units).  The final record of the file is
        normalized with a trailing delimiter if missing."""
        size = os.path.getsize(path)
        if size == 0 or stripe.start >= size:
            return
        data = np.memmap(path, dtype=np.uint8, mode="r")
        start = self._next_record_start(data, stripe.start)
        end = (
            size
            if stripe.stop >= size
            else self._next_record_start(data, stripe.stop)
        )
        if start >= end:
            return
        ends = self._record_ends(data, start, end)
        unterminated = end == size and (
            ends.size == 0 or int(ends[-1]) != size
        )
        if unterminated:
            # normalized end is one past EOF: the missing delimiter is
            # appended to the blob below and counted in the offsets
            ends = np.concatenate([ends, [size + 1]])
        bounds = np.concatenate([[start], ends]).astype(np.int64)
        n = ends.shape[0]
        for r0 in range(0, n, batch_records):
            r1 = min(r0 + batch_records, n)
            blob = np.array(data[bounds[r0] : min(bounds[r1], size)])
            if bounds[r1] > size:
                blob = np.concatenate([blob, [np.uint8(self._delim)]])
            yield self._block(blob, bounds[r0 : r1 + 1] - bounds[r0])

    def parse_blob(self, blob: bytes) -> RecordBlock:
        """Spill-blob reload: every spilled record is delimiter-terminated
        (blocks are normalized at read time), so offsets re-derive by a
        single delimiter scan."""
        data = np.frombuffer(blob, dtype=np.uint8)
        if data.size and data[-1] != self._delim:
            raise ValueError("line spill blob does not end with delimiter")
        ends = np.flatnonzero(data == self._delim).astype(np.int64) + 1
        offsets = np.concatenate([np.zeros(1, np.int64), ends])
        return self._block(data, offsets)

    def read_block(
        self, path: str, offsets: np.ndarray | None = None
    ) -> RecordBlock:
        """Whole-file block.  With ``offsets`` (the manifest's sidecar
        array) the delimiter rescan is skipped and ``data`` stays an
        mmap; without it the file is scanned once.  A file whose final
        line is unterminated is normalized into an owned copy."""
        size = os.path.getsize(path)
        if size == 0:
            return self._block(np.empty(0, np.uint8), np.zeros(1, np.int64))
        data = np.memmap(path, dtype=np.uint8, mode="r")
        if offsets is not None:
            offsets = np.asarray(offsets, dtype=np.int64)
            if offsets[-1] != size:
                raise ValueError(
                    f"offsets sidecar covers {int(offsets[-1])} bytes but "
                    f"{path!r} holds {size} — stale sidecar?"
                )
            return self._block(data, offsets)
        ends = self._record_ends(data, 0, size)
        if ends.size == 0 or int(ends[-1]) != size:
            data = np.concatenate([data, [np.uint8(self._delim)]])
            ends = np.concatenate([ends, [data.shape[0]]])
        offsets = np.concatenate([np.zeros(1, np.int64), ends])
        return self._block(data, offsets)

    # -- sampling ------------------------------------------------------

    def estimate_n_records(self, path: str) -> int:
        """Deterministic record-count estimate from the head of the file
        (exact when the file fits one scan chunk)."""
        size = os.path.getsize(path)
        if size == 0:
            return 0
        with open(path, "rb") as f:
            head = f.read(min(size, 1 << 20))
        n_delim = head.count(self.delimiter)
        if len(head) == size:
            return n_delim + (0 if head.endswith(self.delimiter) else 1)
        avg = len(head) / max(n_delim, 1)
        return max(1, int(size / avg))

    def sample_keys(
        self, path: str, n_records: int, sample_frac: float
    ) -> np.ndarray:
        """Key sample from contiguous runs at 64 evenly-spaced *byte*
        offsets, snapped to record starts — a pure function of the file,
        independent of the reader count."""
        size = os.path.getsize(path)
        if size == 0:
            return np.empty((0, self.max_key_bytes), dtype=np.uint8)
        n_stripes = 64
        take = min(
            max(int(n_records * sample_frac), 1024), 10_000_000,
            max(n_records, 1),
        )
        per_stripe = max(take // n_stripes, 16)
        avg = max(size / max(n_records, 1), 1.0)
        run_bytes = int(per_stripe * avg * 2) + 4096
        data = np.memmap(path, dtype=np.uint8, mode="r")
        rng = np.random.default_rng(0)
        keys = []
        for s in range(n_stripes):
            at = int(s * size / n_stripes)
            start = self._next_record_start(data, at)
            if start >= size:
                continue
            end = min(start + run_bytes, size)
            ends = self._record_ends(data, start, end)
            if ends.size == 0:
                continue
            bounds = np.concatenate([[start], ends]).astype(np.int64)
            run = line_keys(data, bounds, self.max_key_bytes)
            keys.append(run[:per_stripe])
        if not keys:
            # interior of one giant unterminated line: key of the whole file
            blk = self.read_block(path)
            return blk.keys
        out = np.concatenate(keys)
        if out.shape[0] > take:
            # in-file order preserved for the planner's order diagnostics
            sel = np.sort(rng.choice(out.shape[0], take, replace=False))
            out = out[sel]
        return out

    # -- manifest serialization ---------------------------------------

    def manifest_fields(self) -> dict:
        return {
            "fmt_kind": np.array(self.kind),
            "fmt_max_key_bytes": np.int64(self.max_key_bytes),
            "fmt_delimiter": np.frombuffer(self.delimiter, dtype=np.uint8),
        }


# The union the pipeline accepts wherever a ``fmt`` parameter appears.
RecordFormat = Union[FixedFormat, LineFormat]

# Default format: the gensort layout every historical entry point assumes.
GENSORT = FixedFormat(record_bytes=100, key_bytes=10)


def from_manifest_fields(z) -> "FixedFormat | LineFormat":
    """Rebuild a format from manifest npz fields (v2+); v1 manifests
    carry no fields and default to the gensort layout."""
    if "fmt_kind" not in getattr(z, "files", z):
        return GENSORT
    kind = str(np.asarray(z["fmt_kind"]))
    if kind == "fixed":
        return FixedFormat(
            record_bytes=int(z["fmt_record_bytes"]),
            key_bytes=int(z["fmt_key_bytes"]),
        )
    if kind == "line":
        return LineFormat(
            max_key_bytes=int(z["fmt_max_key_bytes"]),
            delimiter=np.asarray(z["fmt_delimiter"], dtype=np.uint8).tobytes(),
        )
    raise ValueError(f"unknown record format kind {kind!r}")
