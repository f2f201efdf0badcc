"""External Mergesort baseline (paper §2): Run-Creation + k-way heap Merge
(a copy of ``src/repro/core/mergesort.py``; host-only, no kernel).

This is the paradigm of GNU sort / MySQL filesort / Postgres tuplesort that
the paper positions against.  We implement it with the same instrumentation
as the ELSAR sorter so the Fig. 2/6/7 benchmark comparisons are
apples-to-apples on this machine:

  phase "run_create": read fixed-size chunks, sort in memory (NumPy stable
      sort on the key bytes — the classical Quicksort slot), write run files
  phase "merge": k-way merge with a binary heap of the head key of each run,
      batched refills (buffered readers) and a coalesced output buffer.

I/O accounting shows the structural difference the paper measures in Fig. 7:
every record is written twice and read twice here (runs + merge), whereas
ELSAR reads twice / writes twice as well BUT its second pass is partition-
local and the merge is replaced by offset-addressed concatenation; the
measured delta comes from the merge's heap traffic and its strictly
sequential single-consumer output.
"""

from __future__ import annotations

import heapq
import os
import tempfile

import numpy as np

from repro_torch.core.external import SortStats, _Timer
from repro_torch.data import gensort


def _sort_chunk(chunk: np.ndarray) -> np.ndarray:
    k = np.ascontiguousarray(chunk[:, : gensort.KEY_BYTES]).view(
        [("k", f"S{gensort.KEY_BYTES}")]
    )["k"].reshape(-1)
    return chunk[np.argsort(k, kind="stable")]


class _RunReader:
    """Buffered reader over one sorted run file."""

    def __init__(self, path: str, stats: SortStats, buf_records: int = 65536):
        self.f = open(path, "rb", buffering=1 << 20)
        self.stats = stats
        self.buf_records = buf_records
        self.buf: np.ndarray | None = None
        self.pos = 0
        self._refill()

    def _refill(self):
        raw = self.f.read(self.buf_records * gensort.RECORD_BYTES)
        self.stats.bytes_read += len(raw)
        if not raw:
            self.buf = None
            return
        self.buf = np.frombuffer(raw, dtype=np.uint8).reshape(
            -1, gensort.RECORD_BYTES
        )
        self.keys = np.ascontiguousarray(
            self.buf[:, : gensort.KEY_BYTES]
        ).view([("k", f"S{gensort.KEY_BYTES}")])["k"].reshape(-1)
        self.pos = 0

    def head_key(self):
        return self.keys[self.pos] if self.buf is not None else None

    def pop(self) -> np.ndarray:
        rec = self.buf[self.pos]
        self.pos += 1
        if self.pos >= self.buf.shape[0]:
            self._refill()
        return rec


def sort_file(
    input_path: str,
    output_path: str,
    *,
    memory_budget_bytes: int = 256 << 20,
    workdir: str | None = None,
) -> SortStats:
    """External Mergesort with the paper's two phases."""
    stats = SortStats()
    file_bytes = os.path.getsize(input_path)
    n = file_bytes // gensort.RECORD_BYTES
    stats.n_records = n
    run_records = max(memory_budget_bytes // (2 * gensort.RECORD_BYTES), 4096)

    tmp = tempfile.mkdtemp(prefix="extms_", dir=workdir)
    src = gensort.read_records(input_path)

    # --- phase 1: run creation
    run_paths = []
    with _Timer(stats, "run_create"):
        for off in range(0, n, run_records):
            chunk = np.asarray(src[off : off + run_records])
            stats.bytes_read += chunk.nbytes
            run = _sort_chunk(chunk)
            path = os.path.join(tmp, f"run{len(run_paths):05d}.bin")
            run.tofile(path)
            stats.bytes_written += run.nbytes
            run_paths.append(path)

    # --- phase 2: k-way heap merge
    with _Timer(stats, "merge"):
        readers = [_RunReader(p, stats) for p in run_paths]
        heap = [
            (r.head_key(), i) for i, r in enumerate(readers) if r.head_key() is not None
        ]
        heapq.heapify(heap)
        out = open(output_path, "wb", buffering=1 << 20)
        out_buf: list[np.ndarray] = []
        out_buf_bytes = 0
        while heap:
            _, i = heapq.heappop(heap)
            rec = readers[i].pop()
            out_buf.append(rec)
            out_buf_bytes += gensort.RECORD_BYTES
            if out_buf_bytes >= (1 << 20):
                blob = np.stack(out_buf).tobytes()
                out.write(blob)
                stats.bytes_written += len(blob)
                out_buf, out_buf_bytes = [], 0
            nk = readers[i].head_key()
            if nk is not None:
                heapq.heappush(heap, (nk, i))
        if out_buf:
            blob = np.stack(out_buf).tobytes()
            out.write(blob)
            stats.bytes_written += len(blob)
        out.close()
    for p in run_paths:
        os.unlink(p)
    os.rmdir(tmp)
    return stats
