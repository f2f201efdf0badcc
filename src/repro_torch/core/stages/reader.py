"""Partition stage: the striped reader pool and its spill files.

Copy of ``src/repro/core/stages/reader.py`` for the PyTorch port.

Each reader owns contiguous stripes of the input (``fmt.file_stripes``),
predicts partition ids with the shared partitioner (the planner's pick:
learned RMI or sample-splitter, DESIGN.md §11), and appends coalesced
fragments to per-partition :class:`PartitionSpill` files.  Fragments are
tagged ``(stripe, seq)`` so the loader can reconstruct exact global input
order no matter which reader flushed first — the determinism story of
DESIGN.md §1.
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np

from repro_torch.core.stages.queues import Abort
from repro_torch.core.stages.stats import PhaseClock

_HAVE_FADVISE = hasattr(os, "posix_fadvise")

# Disk-overflow writes drop their page-cache ranges in batches this
# large: per-fragment advise calls on 32 KB fragments would be syscall
# noise, and dirty-page writeback only engages on meaningful spans.
_SPILL_DONTNEED_BATCH = 4 << 20


def spill_root(workdir: "str | None", *, per_host: bool = False) -> "str | None":
    """Resolve spill placement: an explicit ``workdir`` wins, else the
    ``REPRO_SPILL_DIR`` environment knob (NVMe-aware placement at pod
    scale — point it at node-local flash), else ``None`` (the system
    tempdir).  ``per_host`` appends a ``host<k>`` subdir keyed by the
    ``torch.distributed`` rank (0 when no process group is initialised)
    so processes sharing a path never collide and each spills to
    storage it owns."""
    root = workdir or os.environ.get("REPRO_SPILL_DIR") or None
    if root is None:
        return None
    if per_host:
        import torch.distributed as dist

        k = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
        root = os.path.join(root, f"host{k:03d}")
    os.makedirs(root, exist_ok=True)
    return root


def _writev_all(fd: int, pieces) -> int:
    """Vectored write of every piece (writev may be partial); retry
    slices are memoryviews, so nothing is ever joined or copied."""
    bufs = [memoryview(p) for p in pieces if len(p)]
    total = sum(len(b) for b in bufs)
    while bufs:
        n = os.writev(fd, bufs)
        while bufs and n >= len(bufs[0]):
            n -= len(bufs[0])
            bufs.pop(0)
        if n:
            bufs[0] = bufs[0][n:]
    return total


class SpillBudget:
    """Shared byte budget for RAM-resident spill fragments (§12).

    One instance spans every partition of a sort: ``try_take`` reserves
    room for a fragment (first-come, bounded), ``release`` returns it
    when the partition is drained.  Fragments that don't fit go to disk
    exactly as before — placement affects only *where* bytes wait, never
    their content or order, so output stays byte-identical whatever the
    RAM/disk mix (and whichever thread won the reservation race).
    """

    def __init__(self, limit_bytes: int):
        self.limit = max(0, int(limit_bytes))
        self._lock = threading.Lock()
        self._used = 0
        self.disk_bytes = 0  # fragments that overflowed to disk (total)

    def try_take(self, n: int) -> bool:
        with self._lock:
            if self._used + n <= self.limit:
                self._used += n
                return True
            return False

    def release(self, n: int) -> None:
        with self._lock:
            self._used -= n


class PartitionSpill:
    """One partition's spilled fragments: RAM-first, disk overflow.

    Writers (readers of the input) append pre-coalesced fragment blobs
    under a lock, each tagged ``(stripe, seq)``.  Blobs are opaque record
    bytes — the caller supplies the record count, so the spill layer is
    record-format-agnostic (fixed-stride and delimiter-terminated blobs
    spill identically).  With a :class:`SpillBudget` (``ram``), fragments
    stay in memory while the shared budget lasts and only the overflow
    hits the spill file — on the bench corpus that removes the partition
    phase's write+re-read round trip entirely; ``ram=None`` keeps the
    historical all-disk behavior.  The loader side runs in a single
    thread and may ``prefetch()`` committed fragments *while writers are
    still appending* — segments are recorded only after their bytes hit
    RAM or the file, so reading a recorded segment is always safe.
    ``take()`` finalizes: reads the rest, reorders fragments by
    (stripe, seq) into global input order, and deletes the file.

    I/O accounting is *logical* spill traffic (every fragment counts,
    RAM-resident or not) so ``SortStats`` byte counters stay identical
    across budgets and reader counts; the physical saving is visible in
    wall time and ``SpillBudget.disk_bytes``.
    """

    def __init__(self, path: str, ram: "SpillBudget | None" = None):
        self.path = path
        self._lock = threading.Lock()
        self._wfd = -1  # raw write fd (vectored zero-copy appends)
        self._file_pos = 0  # disk offset of the next disk fragment
        self._dontneed_from = 0  # start of the not-yet-advised dirty range
        self._total = 0  # all fragment bytes, RAM + disk
        self.n_records = 0
        # (stripe, seq, off, len); off == -1 marks a RAM-resident blob
        self.segments: list[tuple[int, int, int, int]] = []
        # segment index -> tuple of fragment pieces (RAM-resident)
        self._mem: dict[int, tuple] = {}
        self._ram = ram
        self._loaded: dict[int, bytes] = {}  # loader-thread-only
        self._n_seen = 0  # loader-side fast-path cursor
        self._read_fd = -1
        self._advised_to = 0  # WILLNEED high-water mark (loader-side)

    @property
    def n_bytes(self) -> int:
        return self._total

    # -- writer side (reader pool) ------------------------------------
    def append(self, stripe: int, seq: int, blob, n_records: int) -> None:
        """Append one fragment.  ``blob`` is a bytes-like or a list of
        bytes-like pieces (the reader's coalescing buffer, handed over
        as-is): RAM-resident fragments keep the pieces unjoined, disk
        overflow writes them zero-copy via ``writev``.  The join — one
        per partition, unavoidable — happens in :meth:`take`."""
        pieces = (
            tuple(blob) if isinstance(blob, (list, tuple)) else (blob,)
        )
        nbytes = sum(len(p) for p in pieces)
        with self._lock:
            idx = len(self.segments)
            if self._ram is not None and self._ram.try_take(nbytes):
                self._mem[idx] = pieces
                self.segments.append((stripe, seq, -1, nbytes))
            else:
                if self._wfd < 0:
                    self._wfd = os.open(
                        self.path,
                        os.O_WRONLY | os.O_CREAT | os.O_TRUNC,
                        0o600,
                    )
                _writev_all(self._wfd, pieces)
                self.segments.append(
                    (stripe, seq, self._file_pos, nbytes)
                )
                self._file_pos += nbytes
                if self._ram is not None:
                    self._ram.disk_bytes += nbytes
                # overflow bytes were *rejected* from the RAM budget —
                # don't let the page cache double-hold them; the loader
                # WILLNEEDs them back one window ahead of its reads
                if (
                    _HAVE_FADVISE
                    and self._file_pos - self._dontneed_from
                    >= _SPILL_DONTNEED_BATCH
                ):
                    try:
                        os.posix_fadvise(
                            self._wfd,
                            self._dontneed_from,
                            self._file_pos - self._dontneed_from,
                            os.POSIX_FADV_DONTNEED,
                        )
                    except OSError:
                        pass
                    self._dontneed_from = self._file_pos
            self._total += nbytes
            self.n_records += n_records

    def close_writer(self) -> None:
        with self._lock:
            if self._wfd >= 0:
                os.close(self._wfd)
                self._wfd = -1

    # -- loader side (single thread) ----------------------------------
    def _open_read_fd(self) -> int:
        if self._read_fd < 0:
            self._read_fd = os.open(self.path, os.O_RDONLY)
            if _HAVE_FADVISE:
                try:
                    os.posix_fadvise(
                        self._read_fd, 0, 0, os.POSIX_FADV_SEQUENTIAL
                    )
                except OSError:
                    pass
        return self._read_fd

    def advise(self) -> None:
        """Hint upcoming reads of committed disk fragments (§15):
        SEQUENTIAL once at open, WILLNEED over the not-yet-read tail.
        The loader calls this one window beyond its prefetch window, so
        the kernel warms pages while the current window's reads are
        still in flight.  Pure hint — a no-op without disk fragments."""
        if not _HAVE_FADVISE:
            return
        with self._lock:
            end = self._file_pos
        if end <= self._advised_to:
            return
        try:
            fd = self._open_read_fd()
            os.posix_fadvise(
                fd,
                self._advised_to,
                end - self._advised_to,
                os.POSIX_FADV_WILLNEED,
            )
        except OSError:
            return
        self._advised_to = end

    def prefetch(self) -> int:
        """Make committed-but-unseen fragments loadable; returns the
        fresh bytes (disk reads + newly visible RAM fragments)."""
        with self._lock:
            committed = len(self.segments)
        done = 0
        for i in range(self._n_seen, committed):
            _, _, off, nbytes = self.segments[i]
            if off < 0:  # RAM-resident: already loaded, count once
                done += nbytes
                continue
            fd = self._open_read_fd()
            self._loaded[i] = os.pread(fd, nbytes, off)
            done += nbytes
        self._n_seen = committed
        return done

    def take(self) -> tuple[bytes | None, int]:
        """Finalize after ``close_writer``: returns (blob, fresh_bytes).

        The blob holds the partition's record bytes in global input order
        (fragments sorted by (stripe, seq)); the spill file is deleted.
        ``fresh_bytes`` counts only bytes first seen by *this* call, so
        prefetched bytes are never double-counted.
        """
        fresh = self.prefetch()
        order = sorted(
            range(len(self.segments)), key=lambda i: self.segments[i][:2]
        )
        if self._read_fd >= 0:
            os.close(self._read_fd)
            self._read_fd = -1
        if os.path.exists(self.path):
            os.unlink(self.path)
        if not order:
            return None, fresh
        parts: list = []
        for i in order:
            if self.segments[i][2] < 0:
                parts.extend(self._mem[i])
            else:
                parts.append(self._loaded[i])
        blob = b"".join(parts)
        if self._ram is not None and self._mem:
            self._ram.release(
                sum(self.segments[i][3] for i in self._mem)
            )
        self._mem.clear()
        self._loaded.clear()
        return blob, fresh


def reader_worker(
    clock: PhaseClock,
    partitioner,
    fmt,
    spills: list[PartitionSpill],
    stripe_q: "queue.SimpleQueue",
    input_path: str,
    cfg,
    abort: threading.Event,
    errors: list,
) -> None:
    """One reader: pull stripes, predict partitions, buffer + flush fragments.

    ``partitioner`` is the planner's pick — learned model or sample
    splitter — behind the shared ``bucket_np(keys) -> int32 ids``
    surface; everything downstream of the bucket ids is identical for
    both.  Buffers are flushed at ``flush_bytes`` and always at stripe
    end, so no fragment ever spans a stripe boundary — the (stripe, seq)
    tag stays a total order over input positions.  The format supplies
    the blocks (fixed strides, or delimiter-split lines) and the
    key-prefix matrix; everything below the key extraction is
    layout-independent.
    """
    n_partitions = len(spills)
    # with many partitions no single buffer may ever reach flush_bytes, so
    # the per-reader TOTAL is also capped at a fair share of the budget —
    # when exceeded, the largest buffer flushes (fewer, bigger fragments)
    reader_cap = max(
        cfg.flush_bytes,
        cfg.memory_budget_bytes // max(4 * cfg.n_readers, 1),
    )
    try:
        while not abort.is_set():
            try:
                stripe = stripe_q.get_nowait()
            except queue.Empty:
                return
            with clock.timer("partition"):
                # fragments are buffered as bytes (not views) so a drained
                # batch's memory is released as soon as the batch is routed
                bufs: dict[int, list[bytes]] = {}
                buf_bytes: dict[int, int] = {}
                buf_recs: dict[int, int] = {}
                seqs: dict[int, int] = {}
                total = 0

                def flush(j: int) -> None:
                    nonlocal total
                    # pieces hand over unjoined: the spill layer writevs
                    # disk overflow zero-copy and keeps RAM fragments as
                    # piece lists — the per-partition join happens once,
                    # in take()
                    pieces = bufs.pop(j)
                    nbytes = buf_bytes.pop(j)
                    total -= nbytes
                    spills[j].append(
                        stripe.index, seqs.get(j, 0), pieces, buf_recs.pop(j)
                    )
                    seqs[j] = seqs.get(j, 0) + 1
                    clock.add_io(written=nbytes)

                for block in fmt.iter_batches(
                    input_path, stripe, cfg.batch_records
                ):
                    clock.add_io(read=block.n_bytes)
                    bucket = partitioner.bucket_np(block.keys)
                    # stable group-by-bucket, then contiguous fragment slices
                    order = np.argsort(bucket, kind="stable")
                    grouped = block.take(order)
                    bcounts = np.bincount(bucket, minlength=n_partitions)
                    starts = np.concatenate([[0], np.cumsum(bcounts)[:-1]])
                    for j in np.nonzero(bcounts)[0]:
                        frag = grouped.slice_bytes(
                            starts[j], starts[j] + bcounts[j]
                        )
                        bufs.setdefault(j, []).append(frag)
                        buf_bytes[j] = buf_bytes.get(j, 0) + len(frag)
                        buf_recs[j] = buf_recs.get(j, 0) + int(bcounts[j])
                        total += len(frag)
                        if buf_bytes[j] >= cfg.flush_bytes:
                            flush(j)
                    while total >= reader_cap:
                        flush(max(buf_bytes, key=buf_bytes.get))
                for j in list(bufs):
                    flush(j)
    except Abort:
        pass
    except BaseException as e:  # surfaced by the orchestrator after joins
        errors.append(e)
        abort.set()
