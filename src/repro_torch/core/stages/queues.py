"""Bounded-queue plumbing shared by the stage workers.

Copy of ``src/repro/core/stages/queues.py`` for the PyTorch port.

``put``/``get`` poll with a short timeout so every worker notices the
shared ``abort`` event promptly (a stage that died must not leave its
neighbours blocked on a full/empty queue forever); ``Abort`` is the
control-flow exception they raise when it fires.
"""

from __future__ import annotations

import queue
import threading


class Abort(Exception):
    """Raised inside a stage worker when the shared abort event fires."""


def put(q: queue.Queue, item, abort: threading.Event) -> None:
    while True:
        try:
            q.put(item, timeout=0.2)
            return
        except queue.Full:
            if abort.is_set():
                raise Abort()


def get(q: queue.Queue, abort: threading.Event):
    while True:
        try:
            return q.get(timeout=0.2)
        except queue.Empty:
            if abort.is_set():
                raise Abort()
