"""Stripe-aligned record serving for the external-sort reader pool.

Copy of the stripe half of ``src/repro/data/pipeline.py`` (``Stripe``,
``record_stripes``, ``byte_stripes``) for the PyTorch port: the input
file is split into contiguous *stripes* (paper §3.2 — each of the r
reader threads owns a contiguous region of the input).  Stripe
boundaries are pure functions of (n_records, n_stripes), so any reader
count re-derives the same global record order.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Stripe:
    """A contiguous run of records: the unit of work for a reader thread.

    ``index`` orders stripes by file position — concatenating stripes by
    ascending index reproduces the whole input in file order, which is what
    lets the sort runtime rebuild input order from per-stripe fragments.
    """

    index: int
    start: int  # first record, inclusive
    stop: int  # last record, exclusive

    @property
    def n_records(self) -> int:
        return self.stop - self.start


def record_stripes(n_records: int, n_stripes: int) -> list[Stripe]:
    """Split ``[0, n_records)`` into ``n_stripes`` contiguous stripes.

    Boundaries depend only on the arguments (never on thread timing), so a
    1-reader and an 8-reader run agree on the global record order.  Stripes
    differ in size by at most one record; empty inputs yield no stripes.
    """
    if n_records <= 0:
        return []
    n_stripes = max(1, min(n_stripes, n_records))
    bounds = np.linspace(0, n_records, n_stripes + 1).astype(np.int64)
    return [
        Stripe(i, int(bounds[i]), int(bounds[i + 1])) for i in range(n_stripes)
    ]


def byte_stripes(n_bytes: int, n_stripes: int) -> list[Stripe]:
    """Split ``[0, n_bytes)`` into contiguous *byte* stripes.

    The variable-length record formats (core/format.LineFormat) stripe by
    byte position — record counts aren't known until the bytes are
    scanned.  Same determinism contract as :func:`record_stripes`: bounds
    are a pure function of the arguments, so any reader count re-derives
    the same global record order (each stripe owns the records that
    *start* inside it; see DESIGN.md §8).
    """
    return record_stripes(n_bytes, n_stripes)
