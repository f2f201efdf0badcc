"""Data pipelines: stripe-aligned record serving for the external-sort
reader pool, plus the token pipeline for LM serving and training.

Copy of ``src/repro/data/pipeline.py`` for the PyTorch port (it imports
NumPy only; ``length_buckets`` fits through the port's
``repro_torch.core.rmi``).

* The **pipelined external sort**: the input file is split into
  contiguous *stripes* (paper §3.2 — each of the r reader threads owns
  a contiguous region of the input).  Stripe boundaries are pure
  functions of (n_records, n_stripes), so any reader count re-derives
  the same global record order.

* The **LM token pipeline**: ``batch_at(step)`` is a pure function of
  (seed, step), with learned length-bucketing for padding-free batching
  (the third consumer of the paper's partitioner, DESIGN.md §4).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

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


def stripe_batches(
    path: str, stripe: Stripe, batch_records: int
) -> Iterator[tuple[int, np.ndarray]]:
    """Yield ``(record_offset, batch)`` covering ``stripe`` in input order.

    Batches are owned copies (not memmap views), safe to hand to another
    thread or mutate.  The memmap is opened once per stripe, and reads are
    sequential within the stripe — the mostly-sequential I/O pattern the
    paper's reader threads rely on (§3.2).
    """
    from repro_torch.data import gensort

    recs = gensort.read_records(path)
    for off in range(stripe.start, stripe.stop, batch_records):
        hi = min(off + batch_records, stripe.stop)
        yield off, np.array(recs[off:hi])


# ---------------------------------------------------------------------------
# LM token pipeline
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


class SyntheticLM:
    """Markov-ish synthetic ids: deterministic function of (seed, step)."""

    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> dict:
        c = self.cfg
        rng = np.random.default_rng((c.seed << 20) ^ step)
        base = rng.integers(0, c.vocab, size=(c.global_batch, c.seq_len))
        # inject local structure so loss can actually decrease
        base[:, 1::2] = (base[:, 0::2] * 31 + 7) % c.vocab
        return {"tokens": base.astype(np.int32)}


class BytesLM:
    """Byte-level LM over a record file (sorted-data curriculum demo)."""

    def __init__(self, cfg: PipelineConfig, path: str):
        from repro_torch.data import gensort

        self.cfg = cfg
        self.records = gensort.read_records(path)

    def batch_at(self, step: int) -> dict:
        c = self.cfg
        n = self.records.shape[0]
        rng = np.random.default_rng((c.seed << 20) ^ step)
        rows = rng.integers(0, n, size=c.global_batch)
        flat = self.records[rows].reshape(c.global_batch, -1)
        tok = flat[:, : c.seq_len].astype(np.int32) % c.vocab
        return {"tokens": tok}


def length_buckets(
    lengths: np.ndarray, n_buckets: int, sample_frac: float = 0.1
) -> np.ndarray:
    """Equi-depth length bucketing via the learned CDF model: returns the
    bucket id per example.  Compared to fixed (equi-width) buckets this
    balances tokens-per-bucket under skewed length distributions —
    identical argument to the paper's §3.3."""
    from repro_torch.core import rmi

    n = len(lengths)
    take = max(int(n * sample_frac), min(n, 64))
    idx = np.random.default_rng(0).choice(n, take, replace=False)
    hi = lengths[idx].astype(np.uint32)
    lo = np.zeros_like(hi)
    model = rmi.fit_encoded(hi, lo, n_leaf=min(1024, max(16, take // 4)))
    return rmi.predict_bucket_np(
        model, lengths.astype(np.uint32), np.zeros(n, np.uint32), n_buckets
    )
