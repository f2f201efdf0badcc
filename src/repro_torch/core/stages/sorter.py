"""Sort stage: a thin adapter that streams queue items through the

Copy of ``src/repro/core/stages/sorter.py`` for the PyTorch port.
pluggable :class:`repro_torch.core.executor.SortExecutor` seam.

The worker owns no sorting logic — it adapts the bounded queues to the
executor's ``sort_iter`` stream protocol.  Executors that batch across
partitions (``BatchedDeviceExecutor``) are driven by a single worker so
one packer owns the super-batch; the stateless host executor may be
driven by several workers sharing the queue.  Phase timing lives inside
the executor (queue waits are not sort work).
"""

from __future__ import annotations

import queue
import threading

from repro_torch.core.stages.queues import Abort, get, put


def sorter_worker(
    executor,
    sort_q: queue.Queue,
    write_q: queue.Queue,
    abort: threading.Event,
    errors: list,
) -> None:
    def feed():
        while True:
            item = get(sort_q, abort)
            if item is None:
                return
            yield item

    try:
        for tag, sorted_block in executor.sort_iter(feed()):
            put(write_q, (tag, sorted_block), abort)
        put(write_q, None, abort)
    except Abort:
        pass
    except BaseException as e:  # surfaced by the orchestrator after joins
        errors.append(e)
        abort.set()
