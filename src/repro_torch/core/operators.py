"""Merge-free external operators over co-partitioned sorted runs
(port of ``src/repro/core/operators.py``; DESIGN.md §9).

The paper motivates external sorting as the engine behind "sort-merge
joins, duplicate removal, sharding, and record clustering".  ELSAR's
merge-free property extends to all of them: two inputs sorted under one
*shared* CDF model (``external.sort_file(model=...)`` with a shared
``n_partitions``) are **co-partitioned** — the bucket id is a function of
the key alone, so partition j of every output covers the identical key
range.  A join / dedup / group-by therefore decomposes into an
embarrassingly parallel *per-partition* streaming pass with zero
multi-way merging, exactly as the sort itself did:

* ``external_join``     — inner + left equi-join on the memcmp key
  window.  Per aligned partition pair, the left side streams in bounded
  row chunks; the matching right span is located by galloping bisect
  probes into the mmap'd right run, then matched with one vectorized
  ``searchsorted`` per chunk.  When a right span exceeds the memory
  budget (duplicate-saturated keys), a **spill fallback** streams each
  key's right run in bounded pieces instead — memory stays bounded for
  any duplicate factor; only the I/O pattern degrades.
* ``external_dedup``    — first-wins (keep the leftmost record of every
  distinct key) or count-annotated (first record + occurrence count).
* ``external_groupby``  — count / sum aggregation over an ASCII numeric
  payload column, one output record per distinct key.

Every operator emits a standard sorted-run output **with its own
manifest** (v3: shared-model hash + per-output partition counts), so
results are immediately servable by ``serve.index.SortedFileIndex`` and
composable with further operators.  The operators themselves are host
NumPy, as in the reference; the device runs the co-partitioned sorts
(``sort_co_partitioned``, on ``SortConfig.device``) and, with
``use_kernels``, the boundary re-bucketing of
:func:`verify_co_partitioning` (one RMI kernel launch for both inputs).  Correctness of the concatenation
relies on two invariants (checked by :func:`verify_co_partitioning`):

1. equal keys always share a bucket (the model is a function of the
   key), so runs of one key never straddle a partition boundary, and
2. bucket ids are monotone in the key (the model is monotone), so
   partition j's keys all sort <= partition j+1's keys — across *both*
   inputs.

Key-window caveat: operators that append payload to a record (join
output, count annotations, group-by rows) require every emitted line's
content to be at least ``key_width`` bytes long, otherwise the appended
suffix would leak into the output's key window and could break its
memcmp order.  The emitters enforce this with an explicit tripwire
rather than producing a silently unsorted file (fixed layouts satisfy
it by construction; keyed line corpora from ``data/lines.py`` do too).
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch.core import encoding, rmi
from repro_torch.core import manifest as manifest_lib
from repro_torch.core.executor import resolve_device
from repro_torch.core.format import GENSORT, FixedFormat, LineFormat, line_keys

COUNT_WIDTH = 10  # zero-padded decimal digits of a dedup count annotation
# zero-padded decimal digits of a group-by aggregate: 19 is the widest
# column an int64 aggregate can fill (10**19 would overflow the digit
# extraction as well as the accumulator)
AGG_WIDTH = 19
_SEP = 0x20  # single-space column separator / left-join fill byte


# ---------------------------------------------------------------------------
# Instrumentation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class OpStats:
    """Instrumentation for one operator pass (the operator ``SortStats``)."""

    op: str = ""
    n_left: int = 0
    n_right: int = 0
    n_out: int = 0
    input_bytes: int = 0
    output_bytes: int = 0
    n_partitions: int = 0
    part_counts: list = dataclasses.field(default_factory=list)
    # right spans that exceeded the in-memory cap and took the bounded
    # per-key streaming path instead
    spill_fallbacks: int = 0
    wall_seconds: float = 0.0
    manifest_path: str | None = None

    def rate_mb_s(self) -> float:
        return self.input_bytes / max(self.wall_seconds, 1e-9) / 1e6


# ---------------------------------------------------------------------------
# Sorted-run access (mmap-backed, chunk-bounded)
# ---------------------------------------------------------------------------


class _Run:
    """One co-partitioned sorted run: mmap'd records + its manifest."""

    def __init__(self, path: str, m: manifest_lib.SortManifest):
        self.path = path
        self.manifest = m
        self.fmt = m.fmt
        self.kw = self.fmt.key_width
        self._kdt = f"S{self.kw}"
        if self.fmt.kind == "line":
            if m.line_offsets is None:
                raise ValueError(
                    f"line manifest for {path!r} lacks the offsets sidecar"
                )
            self.block = self.fmt.read_block(path, offsets=m.line_offsets)
        else:
            self.block = self.fmt.read_block(path)
        if self.block.n_records != m.n_records:
            raise ValueError(
                f"{path!r} holds {self.block.n_records} records but its "
                f"manifest says {m.n_records} — stale sidecar?"
            )
        self.n = self.block.n_records
        self.starts = m.part_starts()
        self.bytes = int(self.block.offsets[-1])

    @classmethod
    def open(cls, path: str, manifest_path: str | None = None) -> "_Run":
        mpath = manifest_path or manifest_lib.manifest_path(path)
        return cls(path, manifest_lib.load(mpath))

    # -- keys ----------------------------------------------------------

    def skeys(self, a: int, b: int) -> np.ndarray:
        """(b - a,) |S{kw}| zero-padded key window of rows [a, b)."""
        if self.fmt.kind == "fixed":
            mat = self.block.data.reshape(-1, self.fmt.record_bytes)
            keys = np.ascontiguousarray(mat[a:b, : self.kw])
        else:
            keys = line_keys(
                self.block.data, self.block.offsets[a : b + 1], self.kw
            )
        return keys.view([("k", self._kdt)])["k"].reshape(-1)

    def key_at(self, i: int) -> bytes:
        """Single key probe in the same trailing-NUL-**stripped** form
        that indexing an |S| array produces.  Every comparison in this
        module mixes these probes with ``skeys()`` values, and Python
        bytes comparison does NOT ignore trailing NULs (numpy's S
        semantics do) — a padded probe against a stripped query would
        misorder ``b"zz\\x00" > b"zz"`` and silently drop join matches
        for records shorter than the key window.  Stripping is exactly
        the S-view equivalence (NUL is the minimum byte, padding only
        ever trails), so stripped-vs-stripped memcmp == the sorter's
        own key order."""
        off = self.block.offsets
        if self.fmt.kind == "fixed":
            raw = self.block.data[off[i] : off[i] + self.kw].tobytes()
        else:
            end = min(off[i] + self.kw, off[i + 1] - 1)
            raw = self.block.data[off[i] : end].tobytes()
        return raw.rstrip(b"\x00")

    def padded_key_at(self, i: int) -> bytes:
        """Zero-padded ``kw``-byte form (for fixed-width key matrices)."""
        return self.key_at(i)[: self.kw].ljust(self.kw, b"\x00")

    def bisect(self, lo: int, hi: int, key: bytes, side: str) -> int:
        """searchsorted(key, side) over rows [lo, hi) via O(log) probes.
        ``key`` must be in stripped (S-view) form — pass ``bytes(k)`` of
        an ``skeys()`` element or a ``key_at()`` result."""
        while lo < hi:
            mid = (lo + hi) // 2
            k = self.key_at(mid)
            if k < key or (side == "right" and k == key):
                lo = mid + 1
            else:
                hi = mid
        return lo

    # -- byte spans ----------------------------------------------------

    def record_spans(self, rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(starts, lens) of whole records (line records keep the delim)."""
        off = self.block.offsets
        starts = off[rows]
        return starts, off[rows + 1] - starts

    def content_spans(self, rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(starts, lens) of record *content* (delimiter excluded)."""
        starts, lens = self.record_spans(rows)
        if self.fmt.kind == "line":
            lens = lens - 1
        return starts, lens

    def tail_spans(self, rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(starts, lens) of content *beyond the key window* — the payload
        a join appends to the left record."""
        starts, clens = self.content_spans(rows)
        skip = np.minimum(clens, self.kw)
        return starts + skip, clens - skip


# ---------------------------------------------------------------------------
# Vectorized byte scatter/gather
# ---------------------------------------------------------------------------


def _scatter(
    dst: np.ndarray,
    dst_starts: np.ndarray,
    lens: np.ndarray,
    src,
    src_starts: np.ndarray,
) -> None:
    """dst[dst_starts[i] : +lens[i]] = src[src_starts[i] : +lens[i]] for
    all pieces in one vectorized gather (no per-piece Python loop)."""
    lens = np.asarray(lens, dtype=np.int64)
    total = int(lens.sum())
    if total == 0:
        return
    cum = np.concatenate([[0], np.cumsum(lens)[:-1]])
    within = np.arange(total, dtype=np.int64) - np.repeat(cum, lens)
    d = np.repeat(np.asarray(dst_starts, dtype=np.int64), lens) + within
    s = np.repeat(np.asarray(src_starts, dtype=np.int64), lens) + within
    dst[d] = np.asarray(src)[s]


def _digits(values: np.ndarray, width: int) -> np.ndarray:
    """(m, width) uint8 zero-padded ASCII decimal aggregate column."""
    return encoding.ascii_digits(values, width)


def _ascii_values(
    run: _Run, a: int, b: int, value_offset: int, value_width: int
) -> np.ndarray:
    """Parse the ASCII numeric payload column of rows [a, b): digits at
    content bytes [value_offset, value_offset + value_width); non-digit
    bytes (space padding) contribute zero."""
    rows = np.arange(a, b, dtype=np.int64)
    starts, clens = run.content_spans(rows)
    if clens.size and int(clens.min()) < value_offset + value_width:
        raise ValueError(
            f"group-by value column [{value_offset}, "
            f"{value_offset + value_width}) exceeds a record's content "
            f"({int(clens.min())} bytes) in {run.path!r}"
        )
    pos = starts[:, None] + value_offset + np.arange(value_width)
    d = np.asarray(run.block.data)[pos].astype(np.int64) - ord("0")
    digit = (d >= 0) & (d <= 9)
    pow10 = 10 ** np.arange(value_width - 1, -1, -1, dtype=np.int64)
    return (np.where(digit, d, 0) * pow10).sum(axis=1)


# ---------------------------------------------------------------------------
# Output writer
# ---------------------------------------------------------------------------


class _OpWriter:
    """Sequential output-run writer tracking per-partition record counts
    (the manifest's per-input partition row counts)."""

    def __init__(self, path: str, out_fmt):
        self.path = path
        self.out_fmt = out_fmt
        self._f = open(path, "wb")
        self.part_counts: list[int] = []
        self._cur = 0
        self.n_out = 0
        self.bytes = 0

    def emit(self, buf: np.ndarray, n_records: int) -> None:
        self._f.write(memoryview(np.ascontiguousarray(buf)))
        self._cur += n_records
        self.n_out += n_records
        self.bytes += int(buf.shape[0])

    def end_partition(self) -> None:
        self.part_counts.append(self._cur)
        self._cur = 0

    def finish(self, model: rmi.RMIParams, emit_manifest: bool) -> str | None:
        self._f.close()
        if not emit_manifest:
            return None
        m = manifest_lib.build(
            model, self.part_counts, self.path, fmt=self.out_fmt
        )
        mpath = manifest_lib.manifest_path(self.path)
        manifest_lib.save(m, mpath)
        return mpath


def _guard_window(is_line: bool, content_lens: np.ndarray, kw: int,
                  appended: np.ndarray, what: str) -> None:
    """Tripwire: appending payload to a line whose content is shorter
    than the key window would leak the suffix into the window and could
    break the output's memcmp order — refuse instead."""
    if not is_line:
        return
    short = content_lens < kw
    if bool((short & (appended > 0)).any()):
        raise ValueError(
            f"{what}: a record's content is shorter than the {kw}-byte key "
            f"window; the appended column would enter the window and break "
            f"output order.  Use a narrower window (<= min content length) "
            f"or un-annotated output."
        )


# ---------------------------------------------------------------------------
# Alignment checks
# ---------------------------------------------------------------------------


def _check_aligned(a: _Run, b: _Run) -> None:
    ma, mb = a.manifest, b.manifest
    if ma.model_hash != mb.model_hash:
        raise ValueError(
            f"{a.path!r} and {b.path!r} were sorted under different models "
            f"({ma.model_hash[:12]} vs {mb.model_hash[:12]}) — re-sort both "
            f"under one shared model (external.sort_file(model=...) or "
            f"operators.sort_co_partitioned)"
        )
    if ma.n_partitions != mb.n_partitions:
        raise ValueError(
            f"partition counts differ ({ma.n_partitions} vs "
            f"{mb.n_partitions}) — co-partitioned sorts must share "
            f"n_partitions"
        )
    if ma.fmt.kind != mb.fmt.kind or ma.fmt.key_width != mb.fmt.key_width:
        raise ValueError(
            f"record formats are not join-compatible: {ma.fmt} vs {mb.fmt}"
        )


def verify_co_partitioning(
    left: _Run, right: _Run, *, use_kernels: bool = False, device="cuda"
) -> int:
    """Re-bucket every partition's boundary keys (first + last record of
    each non-empty partition, both inputs) through the shared model and
    assert each lands in its own partition.  With ``use_kernels`` the
    check runs through the dual-input RMI path
    (``kernels.ops.rmi_bucket_pair``) on ``device``: on the card one
    kernel launch for both inputs (``"cuda"``, the default, raises
    without a GPU), on the CPU the kernel's plain version.  Without it,
    the host's NumPy predictor (the partitioner's own).  The kernel is
    bit-equal to the eager float32 prediction, and the partitioner
    routes with the NumPy one, so a boundary key that re-buckets
    elsewhere is a fault either way: it raises, naming the key.
    Returns the number of keys checked."""
    model = left.manifest.model
    n_parts = left.manifest.n_partitions

    def boundary_keys(run: _Run) -> tuple[np.ndarray, np.ndarray]:
        rows, expect = [], []
        for j in range(n_parts):
            a, b = int(run.starts[j]), int(run.starts[j + 1])
            if a == b:
                continue
            rows += [a, b - 1]
            expect += [j, j]
        keys = np.frombuffer(
            b"".join(run.padded_key_at(i) for i in rows), dtype=np.uint8
        ).reshape(len(rows), run.kw)
        return keys, np.asarray(expect, dtype=np.int64)

    ka, ea = boundary_keys(left)
    kb, eb = boundary_keys(right)
    hi_a, lo_a = encoding.encode_np(ka)
    hi_b, lo_b = encoding.encode_np(kb)
    if use_kernels:
        from repro_torch.kernels import ops as kernel_ops

        dev = resolve_device(device)
        # one upload of all four word arrays, split on the device
        words = np.concatenate([hi_a, lo_a, hi_b, lo_b]).astype(np.int64)
        w = torch.from_numpy(words).to(dev).split(
            [hi_a.size, lo_a.size, hi_b.size, lo_b.size]
        )
        ja, jb = kernel_ops.rmi_bucket_pair(model.to(dev), *w, n_parts)
        ja = ja.cpu().numpy().astype(np.int64)
        jb = jb.cpu().numpy().astype(np.int64)
    else:
        ja = rmi.predict_bucket_np(model, hi_a, lo_a, n_parts).astype(np.int64)
        jb = rmi.predict_bucket_np(model, hi_b, lo_b, n_parts).astype(np.int64)
    for name, got, expect, keys in (
        ("left", ja, ea, ka), ("right", jb, eb, kb)
    ):
        if not np.array_equal(got, expect):
            bad = int(np.flatnonzero(got != expect)[0])
            raise AssertionError(
                f"co-partitioning violated on the {name} input: boundary "
                f"key {keys[bad].tobytes()!r} of partition "
                f"{int(expect[bad])} re-buckets to {int(got[bad])}"
            )
    return int(ea.shape[0] + eb.shape[0])


# ---------------------------------------------------------------------------
# Join
# ---------------------------------------------------------------------------


def _join_out_fmt(left: _Run, right: _Run):
    if left.fmt.kind == "fixed":
        return FixedFormat(
            record_bytes=left.fmt.record_bytes
            + right.fmt.record_bytes
            - right.fmt.key_bytes,
            key_bytes=left.fmt.key_bytes,
        )
    return LineFormat(
        max_key_bytes=left.fmt.max_key_bytes, delimiter=left.fmt.delimiter
    )


def _emit_join(
    writer: _OpWriter,
    left: _Run,
    right: _Run,
    l_rows: np.ndarray,
    r_rows: np.ndarray,
    r_valid: np.ndarray,
) -> None:
    """Emit one batch of join output records (left-major pair order).

    ``r_rows[i]`` is consumed only where ``r_valid[i]``; invalid rows
    (left-join non-matches) get an empty payload (line) or a space-filled
    payload of the fixed stride."""
    m = l_rows.shape[0]
    if m == 0:
        return
    is_line = left.fmt.kind == "line"
    l_starts, l_lens = left.content_spans(l_rows)
    # right spans only for valid rows (placeholder rows may be anything,
    # including out of range when the right run is empty)
    r_starts = np.zeros(m, dtype=np.int64)
    r_tail = np.zeros(m, dtype=np.int64)
    if r_valid.any():
        vs, vl = right.tail_spans(np.asarray(r_rows)[r_valid])
        r_starts[r_valid] = vs
        r_tail[r_valid] = vl
    if is_line:
        r_lens = r_tail  # non-matches append nothing
        _guard_window(True, l_lens, left.kw, r_lens, "join")
        delim = 1
    else:
        # fixed stride: every record carries the payload width;
        # non-matches stay space-filled
        pay_w = right.fmt.record_bytes - right.fmt.key_bytes
        r_lens = np.full(m, pay_w, dtype=np.int64)
        delim = 0
    rec_lens = l_lens + r_lens + delim
    d_starts = np.concatenate(
        [[0], np.cumsum(rec_lens, dtype=np.int64)[:-1]]
    )
    total = int(rec_lens.sum())
    dst = np.full(total, _SEP, dtype=np.uint8)
    _scatter(dst, d_starts, l_lens, left.block.data, l_starts)
    _scatter(
        dst,
        (d_starts + l_lens)[r_valid],
        r_tail[r_valid],
        right.block.data,
        r_starts[r_valid],
    )
    if is_line:
        dst[d_starts + rec_lens - 1] = left.fmt.delimiter[0]
    writer.emit(dst, m)


def _join_partition(
    left: _Run,
    right: _Run,
    j: int,
    how: str,
    chunk_rows: int,
    writer: _OpWriter,
    stats: OpStats,
) -> None:
    la, lb = int(left.starts[j]), int(left.starts[j + 1])
    ra, rb = int(right.starts[j]), int(right.starts[j + 1])
    if la == lb:
        return
    pair_cap = 2 * chunk_rows
    for c0 in range(la, lb, chunk_rows):
        c1 = min(c0 + chunk_rows, lb)
        lk = left.skeys(c0, c1)
        # gallop: the right span that can possibly match this left chunk
        r_lo = right.bisect(ra, rb, bytes(lk[0]), "left")
        r_hi = right.bisect(r_lo, rb, bytes(lk[-1]), "right")
        ra = r_lo  # later left chunks only have larger keys
        if r_hi - r_lo <= chunk_rows:
            # fast path: materialize the span once, one vectorized match
            rk = right.skeys(r_lo, r_hi)
            lo_i = np.searchsorted(rk, lk, side="left").astype(np.int64)
            hi_i = np.searchsorted(rk, lk, side="right").astype(np.int64)
            counts = hi_i - lo_i
            out_counts = (
                counts if how == "inner" else np.maximum(counts, 1)
            )
            cum = np.cumsum(out_counts, dtype=np.int64)
            pos = 0
            while pos < out_counts.shape[0]:
                base = int(cum[pos - 1]) if pos else 0
                # largest end with <= pair_cap output records (always >=
                # one row of progress; a single row's pairs are bounded
                # by the fast-path span cap)
                end = int(np.searchsorted(cum, base + pair_cap, side="right"))
                end = max(end, pos + 1)
                oc = out_counts[pos:end]
                m = int(oc.sum())
                if m:
                    l_rows = np.repeat(
                        np.arange(c0 + pos, c0 + end, dtype=np.int64), oc
                    )
                    seg = np.concatenate(
                        [[0], np.cumsum(oc, dtype=np.int64)[:-1]]
                    )
                    within = np.arange(m, dtype=np.int64) - np.repeat(
                        seg, oc
                    )
                    r_rows = r_lo + np.repeat(lo_i[pos:end], oc) + within
                    r_valid = np.repeat(counts[pos:end] > 0, oc)
                    r_rows = np.where(r_valid, r_rows, ra if ra < rb else 0)
                    _emit_join(writer, left, right, l_rows, r_rows, r_valid)
                pos = end
        else:
            # spill fallback: the span exceeds the in-memory cap — stream
            # each key's right run in bounded pieces (left-major order)
            stats.spill_fallbacks += 1
            uk, first_i, ucnt = np.unique(
                lk, return_index=True, return_counts=True
            )
            rpos = r_lo
            for key, fi, c in zip(uk, first_i, ucnt):
                kb = bytes(key)
                p = right.bisect(rpos, rb, kb, "left")
                q = right.bisect(p, rb, kb, "right")
                rpos = q
                if p == q:
                    if how == "left":
                        rows = np.arange(
                            c0 + int(fi), c0 + int(fi) + int(c),
                            dtype=np.int64,
                        )
                        _emit_join(
                            writer, left, right, rows,
                            np.zeros(int(c), dtype=np.int64),
                            np.zeros(int(c), dtype=bool),
                        )
                    continue
                for t in range(int(c)):
                    lrow = c0 + int(fi) + t
                    for p0 in range(p, q, chunk_rows):
                        p1 = min(p0 + chunk_rows, q)
                        r_rows = np.arange(p0, p1, dtype=np.int64)
                        l_rows = np.full(p1 - p0, lrow, dtype=np.int64)
                        _emit_join(
                            writer, left, right, l_rows, r_rows,
                            np.ones(p1 - p0, dtype=bool),
                        )


def _chunk_rows(budget: int, *runs: _Run) -> int:
    avg = sum(r.bytes / max(r.n, 1) for r in runs) + sum(
        r.kw for r in runs
    )
    return max(256, int((budget // 8) / max(avg, 1.0)))


def external_join(
    left_path: str,
    right_path: str,
    output_path: str,
    *,
    how: str = "inner",
    left_manifest: str | None = None,
    right_manifest: str | None = None,
    memory_budget_bytes: int = 256 << 20,
    chunk_records: int = 0,
    emit_manifest: bool = True,
    verify: bool = False,
    use_kernels: bool = False,
    device="cuda",
) -> OpStats:
    """Merge-free external equi-join of two co-partitioned sorted runs.

    Key equality is memcmp on the shared key window; output records are
    ``left record ++ right payload`` (the right record beyond its key
    window), in left-major pair order — byte-identical to the in-memory
    oracle at any reader count / chunk size.  ``how='left'`` emits
    non-matching left records with an empty (line) or space-filled
    (fixed) payload.  Memory stays bounded by ``memory_budget_bytes``
    regardless of duplicate factor (see module docstring).  ``verify``
    re-buckets the partition boundary keys first
    (:func:`verify_co_partitioning`; through the RMI kernel on
    ``device`` with ``use_kernels``).
    """
    if how not in ("inner", "left"):
        raise ValueError(f"how must be 'inner' or 'left', got {how!r}")
    t0 = time.perf_counter()
    left = _Run.open(left_path, left_manifest)
    right = _Run.open(right_path, right_manifest)
    _check_aligned(left, right)
    if verify:
        verify_co_partitioning(
            left, right, use_kernels=use_kernels, device=device
        )
    chunk = chunk_records or _chunk_rows(memory_budget_bytes, left, right)
    stats = OpStats(
        op=f"join_{how}",
        n_left=left.n,
        n_right=right.n,
        input_bytes=left.bytes + right.bytes,
        n_partitions=left.manifest.n_partitions,
    )
    writer = _OpWriter(output_path, _join_out_fmt(left, right))
    for j in range(left.manifest.n_partitions):
        _join_partition(left, right, j, how, chunk, writer, stats)
        writer.end_partition()
    stats.manifest_path = writer.finish(left.manifest.model, emit_manifest)
    stats.n_out = writer.n_out
    stats.output_bytes = writer.bytes
    stats.part_counts = list(writer.part_counts)
    stats.wall_seconds = time.perf_counter() - t0
    return stats


# ---------------------------------------------------------------------------
# Dedup / group-by (single-input streaming run detection)
# ---------------------------------------------------------------------------


def _partition_runs(run: _Run, j: int, chunk_rows: int, values_fn):
    """Yield ``(first_rows, counts, sums)`` batches of *completed* key
    runs of partition j, streaming in bounded chunks.  Equal keys never
    straddle a partition boundary (same bucket), so runs complete within
    the partition; runs straddling *chunk* boundaries are carried."""
    a, b = int(run.starts[j]), int(run.starts[j + 1])
    pend_row, pend_key, pend_cnt, pend_sum = -1, None, 0, 0
    for c0 in range(a, b, chunk_rows):
        c1 = min(c0 + chunk_rows, b)
        k = run.skeys(c0, c1)
        v = values_fn(run, c0, c1) if values_fn is not None else None
        starts_i = np.concatenate(
            [[0], np.flatnonzero(k[1:] != k[:-1]) + 1]
        ).astype(np.int64)
        cnts = np.diff(np.append(starts_i, c1 - c0))
        sums = (
            np.add.reduceat(v, starts_i)
            if v is not None
            else np.zeros(starts_i.shape[0], dtype=np.int64)
        )
        rows = c0 + starts_i
        if pend_key is not None and k[0] == pend_key:
            pend_cnt += int(cnts[0])
            pend_sum += int(sums[0])
            rows, cnts, sums = rows[1:], cnts[1:], sums[1:]
            if rows.shape[0] == 0:
                continue  # whole chunk extended the pending run
        if pend_key is not None:
            rows = np.concatenate([[pend_row], rows])
            cnts = np.concatenate([[pend_cnt], cnts])
            sums = np.concatenate([[pend_sum], sums])
        # the last run may continue into the next chunk: it pends
        pend_row, pend_cnt, pend_sum = (
            int(rows[-1]), int(cnts[-1]), int(sums[-1]),
        )
        pend_key = k[-1]
        if rows.shape[0] > 1:
            yield rows[:-1], cnts[:-1], sums[:-1]
    if pend_key is not None:
        yield (
            np.array([pend_row], dtype=np.int64),
            np.array([pend_cnt], dtype=np.int64),
            np.array([pend_sum], dtype=np.int64),
        )


def _emit_firsts(writer: _OpWriter, run: _Run, rows: np.ndarray) -> None:
    """Emit first-of-run records unchanged (first-wins dedup)."""
    starts, lens = run.record_spans(rows)
    d_starts = np.concatenate([[0], np.cumsum(lens, dtype=np.int64)[:-1]])
    dst = np.empty(int(lens.sum()), dtype=np.uint8)
    _scatter(dst, d_starts, lens, run.block.data, starts)
    writer.emit(dst, rows.shape[0])


def _emit_annotated(
    writer: _OpWriter, run: _Run, rows: np.ndarray, values: np.ndarray,
    width: int,
) -> None:
    """Emit ``content [sep] zero-padded-value [delim]`` records."""
    is_line = run.fmt.kind == "line"
    starts, clens = run.content_spans(rows)
    extra = width + (2 if is_line else 0)  # line: sep + digits + delim
    _guard_window(
        is_line, clens, run.kw,
        np.full(rows.shape[0], extra, dtype=np.int64), "count annotation",
    )
    rec_lens = clens + extra
    d_starts = np.concatenate([[0], np.cumsum(rec_lens, dtype=np.int64)[:-1]])
    dst = np.empty(int(rec_lens.sum()), dtype=np.uint8)
    _scatter(dst, d_starts, clens, run.block.data, starts)
    dig_at = d_starts + clens + (1 if is_line else 0)
    if is_line:
        dst[d_starts + clens] = _SEP
        dst[d_starts + rec_lens - 1] = run.fmt.delimiter[0]
    dst[dig_at[:, None] + np.arange(width)] = _digits(values, width)
    writer.emit(dst, rows.shape[0])


def _emit_groups(
    writer: _OpWriter, run: _Run, rows: np.ndarray, values: np.ndarray
) -> None:
    """Emit ``key-window [sep] zero-padded-aggregate [delim]`` records."""
    is_line = run.fmt.kind == "line"
    starts, clens = run.content_spans(rows)
    kw = run.kw
    if is_line and clens.size and int(clens.min()) < kw:
        raise ValueError(
            f"group-by: a group's first record has content shorter than "
            f"the {kw}-byte key window — narrow the window to <= min "
            f"content length"
        )
    extra = 1 + AGG_WIDTH + (1 if is_line else 0)
    rec_len = kw + extra
    m = rows.shape[0]
    d_starts = np.arange(m, dtype=np.int64) * rec_len
    dst = np.full(m * rec_len, _SEP, dtype=np.uint8)
    _scatter(dst, d_starts, np.full(m, kw, dtype=np.int64),
             run.block.data, starts)
    dst[(d_starts + kw + 1)[:, None] + np.arange(AGG_WIDTH)] = _digits(
        values, AGG_WIDTH
    )
    if is_line:
        dst[d_starts + rec_len - 1] = run.fmt.delimiter[0]
    writer.emit(dst, m)


def _groupby_out_fmt(run: _Run):
    if run.fmt.kind == "fixed":
        return FixedFormat(
            record_bytes=run.kw + 1 + AGG_WIDTH, key_bytes=run.kw
        )
    return LineFormat(max_key_bytes=run.kw, delimiter=run.fmt.delimiter)


def _dedup_out_fmt(run: _Run, counts: bool):
    if not counts:
        return run.fmt
    if run.fmt.kind == "fixed":
        return FixedFormat(
            record_bytes=run.fmt.record_bytes + COUNT_WIDTH,
            key_bytes=run.fmt.key_bytes,
        )
    return LineFormat(
        max_key_bytes=run.fmt.max_key_bytes, delimiter=run.fmt.delimiter
    )


def _single_input_op(
    op: str,
    input_path: str,
    output_path: str,
    out_fmt,
    emitter,
    values_fn,
    *,
    input_manifest: str | None,
    memory_budget_bytes: int,
    chunk_records: int,
    emit_manifest: bool,
) -> OpStats:
    t0 = time.perf_counter()
    run = _Run.open(input_path, input_manifest)
    chunk = chunk_records or _chunk_rows(memory_budget_bytes, run)
    stats = OpStats(
        op=op,
        n_left=run.n,
        input_bytes=run.bytes,
        n_partitions=run.manifest.n_partitions,
    )
    writer = _OpWriter(output_path, out_fmt(run))
    for j in range(run.manifest.n_partitions):
        for rows, cnts, sums in _partition_runs(run, j, chunk, values_fn):
            emitter(writer, run, rows, cnts, sums)
        writer.end_partition()
    stats.manifest_path = writer.finish(run.manifest.model, emit_manifest)
    stats.n_out = writer.n_out
    stats.output_bytes = writer.bytes
    stats.part_counts = list(writer.part_counts)
    stats.wall_seconds = time.perf_counter() - t0
    return stats


def external_dedup(
    input_path: str,
    output_path: str,
    *,
    counts: bool = False,
    input_manifest: str | None = None,
    memory_budget_bytes: int = 256 << 20,
    chunk_records: int = 0,
    emit_manifest: bool = True,
) -> OpStats:
    """Merge-free duplicate removal over one sorted run.

    First-wins by default: the leftmost record of every distinct key
    window survives, unchanged (output format == input format).  With
    ``counts=True`` each survivor is annotated with its occurrence count
    (zero-padded ``COUNT_WIDTH`` ASCII digits appended as a column).
    """

    def emitter(writer, run, rows, cnts, sums):
        if counts:
            _emit_annotated(writer, run, rows, cnts, COUNT_WIDTH)
        else:
            _emit_firsts(writer, run, rows)

    return _single_input_op(
        "dedup_counts" if counts else "dedup",
        input_path, output_path,
        lambda run: _dedup_out_fmt(run, counts),
        emitter, None,
        input_manifest=input_manifest,
        memory_budget_bytes=memory_budget_bytes,
        chunk_records=chunk_records,
        emit_manifest=emit_manifest,
    )


def external_groupby(
    input_path: str,
    output_path: str,
    *,
    agg: str = "count",
    value_offset: int = 0,
    value_width: int = 0,
    input_manifest: str | None = None,
    memory_budget_bytes: int = 256 << 20,
    chunk_records: int = 0,
    emit_manifest: bool = True,
) -> OpStats:
    """Merge-free group-by over one sorted run: one output record per
    distinct key window, ``key-window sep aggregate``.

    ``agg='count'`` counts group members; ``agg='sum'`` sums the ASCII
    numeric payload column at content bytes ``[value_offset,
    value_offset + value_width)`` (space padding reads as 0).
    """
    if agg not in ("count", "sum"):
        raise ValueError(f"agg must be 'count' or 'sum', got {agg!r}")
    if agg == "sum" and value_width <= 0:
        raise ValueError("agg='sum' requires value_width > 0")

    values_fn = None
    if agg == "sum":
        def values_fn(run, a, b):
            return _ascii_values(run, a, b, value_offset, value_width)

    def emitter(writer, run, rows, cnts, sums):
        _emit_groups(writer, run, rows, cnts if agg == "count" else sums)

    return _single_input_op(
        f"groupby_{agg}",
        input_path, output_path, _groupby_out_fmt, emitter, values_fn,
        input_manifest=input_manifest,
        memory_budget_bytes=memory_budget_bytes,
        chunk_records=chunk_records,
        emit_manifest=emit_manifest,
    )


# ---------------------------------------------------------------------------
# Shared-model sorting front door
# ---------------------------------------------------------------------------


def sort_co_partitioned(
    inputs: "list[str]",
    outputs: "list[str]",
    config=None,
    **overrides,
):
    """Sort N inputs under ONE shared model -> co-partitioned outputs.

    Samples every input, trains a single CDF model on the union sample,
    then sorts each input with that model and a shared partition count
    (the max of the per-input budget-derived sizings), emitting a v3
    manifest per output.  Returns ``(model, [SortStats, ...])``; the
    outputs are then directly consumable by the operators above.

    Takes the same ``repro_torch.core.config.SortConfig`` (+ field
    overrides) as ``external.sort_file`` — all N inputs run through the
    identical configuration, so their outputs stay byte-comparable, and
    each sort runs on ``SortConfig.device`` (the card by default).
    ``model`` and ``n_partitions`` are decided here (the shared-model
    contract) and override whatever the config carries; the model is
    trained on the host.
    """
    from repro_torch.core import external
    from repro_torch.core.config import coerce_sort_config
    from repro_torch.core.pipeline import _resolve_fmt, _train_stage

    if len(inputs) != len(outputs):
        raise ValueError("inputs and outputs must pair up")
    if config is None and "flush_bytes" not in overrides:
        # historical default: operators flushed at 1 MiB fragments
        # rather than the pipeline's auto-tuned threshold
        overrides["flush_bytes"] = 1 << 20
    cfg = coerce_sort_config(config, overrides, warn=False)
    use_fmt = _resolve_fmt(cfg.fmt) or GENSORT
    samples = []
    for p in inputs:
        if use_fmt.kind == "fixed":
            n_est = use_fmt.count_records(p)
        else:
            n_est = use_fmt.estimate_n_records(p)
        samples.append(use_fmt.sample_keys(p, n_est, cfg.sample_frac))
    model = _train_stage(np.concatenate(samples), cfg.n_leaf)
    n_partitions = cfg.n_partitions
    if n_partitions == 0:
        target = max(cfg.memory_budget_bytes // 4, 1 << 20)
        n_partitions = max(
            1,
            max(
                int(np.ceil(os.path.getsize(p) / target)) for p in inputs
            ),
        )
    cfg = cfg.replace(
        n_partitions=n_partitions, manifest=True, model=model
    )
    stats = [
        external.sort_file(inp, out, cfg)
        for inp, out in zip(inputs, outputs)
    ]
    return model, stats
