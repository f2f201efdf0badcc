"""Load stage: drain spilled fragments into memory and feed the sorter(s).

Copy of ``src/repro/core/stages/loader.py`` for the PyTorch port.

While the partition phase is in flight, eagerly pre-reads fragments
already committed for the next few partitions (bounded window); once
fragment sets are final, parses each partition's blob back into a
RecordBlock (the format re-derives offsets/keys) and emits partitions in
ascending key order.

The prefetch window is the upstream half of the executor's double
buffer (§12): it spans the partitions of the *next* super-batch
(``cfg.batch_segments``), byte-capped at a quarter of the memory
budget, and keeps running through the drain phase — so the disk reads
for batch k+1 overlap the pack/dispatch/fetch of batch k instead of
serializing in front of it.
"""

from __future__ import annotations

import queue
import threading

from repro_torch.core.stages.queues import Abort, put
from repro_torch.core.stages.reader import PartitionSpill
from repro_torch.core.stages.stats import PhaseClock


def loader_worker(
    clock: PhaseClock,
    fmt,
    spills: list[PartitionSpill],
    offsets_box: dict,
    partition_done: threading.Event,
    sort_q: queue.Queue,
    cfg,
    n_sorters: int,
    abort: threading.Event,
    errors: list,
) -> None:
    """Single loader thread; emits ``(write_offset, RecordBlock)`` items
    followed by one ``None`` sentinel per sorter worker."""
    try:
        emit = 0
        # the window covers the next super-batch (the executor packs up
        # to batch_segments partitions per dispatch), byte-capped below
        window = max(
            cfg.queue_depth + 1,
            getattr(cfg, "batch_segments", 0) + cfg.queue_depth,
        )
        ahead_bytes = max(cfg.memory_budget_bytes // 4, 1 << 20)
        n_parts = len(spills)

        def read_ahead(start: int) -> int:
            """Prefetch committed fragments for partitions in the window
            after ``start``; stops at the byte cap."""
            progressed, budget = 0, ahead_bytes
            stop = min(start + window, n_parts)
            for k in range(start, stop):
                budget -= spills[k].n_bytes
                if budget < 0 and k > start:
                    break
                with clock.timer("sort_read") as t:
                    got = spills[k].prefetch()
                    clock.add_io(read=got)
                    if not got:
                        t.discard()  # idle poll, not sort_read work
                progressed += got
            # fadvise SEQUENTIAL+WILLNEED one window further out (§15):
            # the kernel warms disk-overflow pages for window k+1 while
            # window k's preads are in flight — pure hint, no bytes read
            for k in range(stop, min(stop + window, n_parts)):
                spills[k].advise()
            return progressed

        while emit < n_parts and not abort.is_set():
            if partition_done.is_set():
                # keep the window warm: batch k+1's disk reads overlap
                # batch k's sort/write downstream
                read_ahead(emit + 1)
                with clock.timer("sort_read"):
                    blob, fresh = spills[emit].take()
                    clock.add_io(read=fresh)
                    block = (
                        fmt.parse_blob(blob) if blob is not None else None
                    )
                if block is not None:
                    put(sort_q, (offsets_box["offsets"][emit], block), abort)
                emit += 1
            else:
                if not read_ahead(emit):
                    partition_done.wait(0.02)
        for _ in range(n_sorters):
            put(sort_q, None, abort)
    except Abort:
        pass
    except BaseException as e:  # surfaced by the orchestrator after joins
        errors.append(e)
        abort.set()
