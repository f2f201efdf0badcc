"""Write stage: zero-copy parallel positioned writes (paper §3.5,

Copy of ``src/repro/core/stages/writer.py`` for the PyTorch port.
DESIGN.md §15).

Mutually exclusive equi-depth partitions make every output offset known
before any sort finishes, so writes are embarrassingly parallel
positioned I/O: no merge, no ordering constraint, no shared file
position.  :class:`WriterPool` runs N workers over one shared fd, each
issuing ``os.pwrite`` at the block's precomputed offset — the syscall
releases the GIL, so the workers genuinely overlap with the sorters and
with each other.  Blocks travel as ``memoryview``s over the
``RecordBlock`` buffers (``RecordBlock.memview``), not ``tobytes()``
copies; the only per-block GIL-held work is acquiring the view, which
is accounted under ``write_prep`` so the ``write`` phase stays pure
disk time.

The pool owns output-file creation: ``O_CREAT`` + ``posix_fallocate``
(``ftruncate`` fallback), so embedders may hand it a fresh path — the
historical ``open(path, "r+b")`` writer required a pre-created file.
Written ranges are dropped from the page cache with
``posix_fadvise(POSIX_FADV_DONTNEED)`` so output writeback never evicts
the loader's spill read-ahead.  A debug tripwire asserts the
disjoint-offset invariant: any two blocks claiming overlapping byte
ranges is a partitioning bug, caught here before it silently corrupts
output.
"""

from __future__ import annotations

import bisect
import os
import queue
import threading
import time

from repro_torch.core.stages.queues import Abort, get, put
from repro_torch.core.stages.stats import PhaseClock

_HAVE_FADVISE = hasattr(os, "posix_fadvise")


def _fadvise_dontneed(fd: int, offset: int, length: int) -> None:
    """Best-effort page-cache drop of a written range (Linux initiates
    writeback of dirty pages in the range and frees the clean ones)."""
    if length <= 0 or not _HAVE_FADVISE:
        return
    try:
        os.posix_fadvise(fd, offset, length, os.POSIX_FADV_DONTNEED)
    except OSError:
        pass


def _pwrite_all(fd: int, buf, offset: int) -> int:
    """Positioned write of the whole buffer (pwrite may be partial);
    slices are memoryview-on-memoryview, so retries never copy."""
    view = memoryview(buf)
    if view.format != "B":
        view = view.cast("B")
    n = len(view)
    done = 0
    while done < n:
        done += os.pwrite(fd, view[done:] if done else view, offset + done)
    return n


class WriterPool:
    """N positioned writers draining one queue onto one shared output fd.

    Termination mirrors the single-writer protocol: the sorters enqueue
    ``n_sorters`` ``None`` sentinels *after* their last block, so the
    worker that consumes the final sentinel knows the queue is drained
    and broadcasts one poison pill per peer to release them.

    Per-writer byte and stall accounting (``writer_bytes``,
    ``writer_stall_seconds``) is what lets the benchmarks prove the
    overlap: a saturated pool shows near-equal bytes and stall time
    dominated by queue waits, a starved one shows the sorters as the
    bottleneck.
    """

    def __init__(
        self,
        clock: PhaseClock,
        output_path: str,
        write_q: queue.Queue,
        n_sorters: int,
        abort: threading.Event,
        errors: list,
        *,
        n_writers: int = 1,
        out_bytes: int = 0,
        create: bool = True,
    ):
        self.clock = clock
        self.write_q = write_q
        self.abort = abort
        self.errors = errors
        self.n_writers = max(1, int(n_writers))
        self._sentinels = int(n_sorters)
        self._lock = threading.Lock()
        self._ranges: list[tuple[int, int]] = []  # claimed (start, end)
        self.writer_bytes = [0] * self.n_writers
        self.writer_stall_seconds = [0.0] * self.n_writers
        # the pool owns creation + preallocation (contiguous extents on
        # ext4/xfs, and ENOSPC surfaces here instead of mid-sort);
        # ``create=False`` opens a file another process created and
        # preallocated (the distributed sort's ranks other than 0)
        flags = os.O_RDWR | (os.O_CREAT | os.O_TRUNC if create else 0)
        self.fd = os.open(output_path, flags, 0o644)
        try:
            if create and out_bytes > 0:
                try:
                    os.posix_fallocate(self.fd, 0, out_bytes)
                except (OSError, AttributeError):
                    os.ftruncate(self.fd, out_bytes)
        except BaseException:
            os.close(self.fd)
            raise
        self.threads = [
            threading.Thread(
                target=self._worker,
                args=(i,),
                name=f"elsar-writer-{i}",
                daemon=True,
            )
            for i in range(self.n_writers)
        ]

    def start(self) -> None:
        for t in self.threads:
            t.start()

    def join(self) -> None:
        for t in self.threads:
            t.join()
        self._close()

    def _close(self) -> None:
        if self.fd >= 0:
            os.close(self.fd)
            self.fd = -1

    def _claim(self, offset: int, length: int) -> None:
        """Disjoint-offset tripwire: partitions are mutually exclusive by
        construction (§3.5), so overlapping write ranges mean a
        partitioning/offset bug — fail loudly before corrupting output."""
        span = (int(offset), int(offset) + int(length))
        with self._lock:
            i = bisect.bisect_left(self._ranges, span)
            if (i > 0 and self._ranges[i - 1][1] > span[0]) or (
                i < len(self._ranges) and self._ranges[i][0] < span[1]
            ):
                raise RuntimeError(
                    f"writer range overlap at [{span[0]}, {span[1]}): "
                    f"partition offsets must be disjoint by construction"
                )
            self._ranges.insert(i, span)

    def _consume_sentinel(self) -> bool:
        """Returns True when this worker should exit.  The consumer of
        the LAST real sentinel broadcasts poison pills to its peers."""
        with self._lock:
            self._sentinels -= 1
            remaining = self._sentinels
        if remaining > 0:
            return False
        if remaining == 0:
            for _ in range(self.n_writers - 1):
                put(self.write_q, None, self.abort)
        return True  # remaining < 0 is a peer's poison pill

    def _worker(self, wid: int) -> None:
        clock = self.clock
        try:
            while True:
                t0 = time.perf_counter()
                item = get(self.write_q, self.abort)
                self.writer_stall_seconds[wid] += time.perf_counter() - t0
                if item is None:
                    if self._consume_sentinel():
                        return
                    continue
                offset, sorted_block = item
                # GIL-held buffer acquisition is "write_prep": the
                # "write" phase below is syscall (disk) time only
                with clock.timer("write_prep"):
                    buf = sorted_block.memview()
                    self._claim(offset, len(buf))
                with clock.timer("write"):
                    n = _pwrite_all(self.fd, buf, offset)
                    clock.add_io(written=n)
                self.writer_bytes[wid] += n
                _fadvise_dontneed(self.fd, offset, n)
        except Abort:
            pass
        except BaseException as e:  # surfaced by the orchestrator after joins
            self.errors.append(e)
            self.abort.set()


def writer_worker(
    clock: PhaseClock,
    output_path: str,
    write_q: queue.Queue,
    n_sorters: int,
    abort: threading.Event,
    errors: list,
) -> None:
    """Single-writer compatibility entry point: the historical stage
    function, now a width-1 :class:`WriterPool` run on the calling
    thread.  Creates the output file if missing (the old ``"r+b"`` open
    required a pre-created file and broke on fresh paths)."""
    try:
        pool = WriterPool(
            clock, output_path, write_q, n_sorters, abort, errors,
            n_writers=1,
        )
    except BaseException as e:
        errors.append(e)
        abort.set()
        return
    try:
        pool._worker(0)
    finally:
        pool._close()
