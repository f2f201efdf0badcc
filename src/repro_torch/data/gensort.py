"""gensort-compatible record generator (paper §7.1).

Copy of ``src/repro/data/gensort.py`` for the PyTorch port.

Records are 100 bytes: a 10-byte printable-ASCII key + 90-byte payload
(the SortBenchmark layout the paper evaluates on).  Two distributions:

* ``uniform`` — every key character i.i.d. uniform over the 95 printable
  ASCII codes (gensort default).
* ``skewed`` — gensort's ``-s`` scheme (paper §7.1): a table of 128 6-byte
  entries; record ``rec_idx`` has its 6 most-significant key bytes replaced
  by ``table[floor(log2(rec_idx)) mod 128]``, producing the "spikes"
  histogram of paper Fig. 3.

``adversarial_keys``/``make_adversarial_records`` are the fixed-format
twins of the hostile line corpora (``data/lines.ADVERSARIAL_KINDS``,
DESIGN.md §11): presorted / reverse / zipf / allequal / tiny 10-digit
decimal keys over the gensort stride, for the planner's differential
grid.
"""

from __future__ import annotations

import numpy as np

KEY_BYTES = 10
PAYLOAD_BYTES = 90
RECORD_BYTES = KEY_BYTES + PAYLOAD_BYTES
ASCII_LO, ASCII_HI = 32, 126  # printable range (95 symbols)
SKEW_TABLE_BYTES = 6
SKEW_TABLE_SIZE = 128


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def uniform_keys(n: int, seed: int = 0) -> np.ndarray:
    return _rng(seed).integers(
        ASCII_LO, ASCII_HI + 1, size=(n, KEY_BYTES), dtype=np.uint8
    )


def skew_table(seed: int = 1234) -> np.ndarray:
    return _rng(seed).integers(
        ASCII_LO, ASCII_HI + 1, size=(SKEW_TABLE_SIZE, SKEW_TABLE_BYTES), dtype=np.uint8
    )


def skewed_keys(n: int, seed: int = 0, start_idx: int = 0) -> np.ndarray:
    """gensort -s: substitute the MSBs with a log2-indexed table entry."""
    keys = uniform_keys(n, seed)
    table = skew_table()
    rec_idx = np.arange(start_idx, start_idx + n, dtype=np.int64)
    rec_idx = np.maximum(rec_idx, 1)  # log2(0) guard
    table_idx = (np.floor(np.log2(rec_idx)).astype(np.int64)) % SKEW_TABLE_SIZE
    keys[:, :SKEW_TABLE_BYTES] = table[table_idx]
    return keys


ADVERSARIAL_KINDS = ("presorted", "reverse", "zipf", "allequal", "tiny")
_ZIPF_A = 1.4
_ZIPF_SPACE = 1_000_000
_TINY_SPACE = 5
# injective mod 10**width (odd, not divisible by 5) — same spreading
# trick as the keyed line corpora (data/lines._SCRAMBLE)
_KEY_SCRAMBLE = 99_999_989


def adversarial_keys(
    n: int, kind: str, seed: int = 0, start_idx: int = 0
) -> np.ndarray:
    """(n, 10) hostile decimal keys; ``start_idx`` keeps presorted /
    reverse globally monotone across ``write_file``-style chunks."""
    from repro_torch.core.encoding import ascii_digits

    if kind not in ADVERSARIAL_KINDS:
        raise ValueError(
            f"unknown adversarial kind {kind!r}; one of {ADVERSARIAL_KINDS}"
        )
    rng = _rng(seed)
    if kind == "presorted":
        vals = np.arange(start_idx, start_idx + n, dtype=np.int64)
    elif kind == "reverse":
        vals = 10**KEY_BYTES - 1 - np.arange(
            start_idx, start_idx + n, dtype=np.int64
        )
    elif kind == "zipf":
        ranks = np.minimum(
            rng.zipf(_ZIPF_A, size=n).astype(np.int64), _ZIPF_SPACE
        )
        vals = (ranks * _KEY_SCRAMBLE) % (10**KEY_BYTES)
    elif kind == "allequal":
        vals = np.full(n, 4_242_424_242, dtype=np.int64)
    else:  # tiny
        kidx = rng.integers(0, _TINY_SPACE, size=n).astype(np.int64)
        vals = (kidx * _KEY_SCRAMBLE) % (10**KEY_BYTES)
    return ascii_digits(vals, KEY_BYTES)


def make_adversarial_records(
    n: int, kind: str, *, seed: int = 0, start_idx: int = 0
) -> np.ndarray:
    """Fixed-layout hostile records: adversarial key + the standard
    id-tagged payload (validators still detect loss/duplication)."""
    rec = make_records(n, seed=seed, start_idx=start_idx)
    rec[:, :KEY_BYTES] = adversarial_keys(n, kind, seed, start_idx)
    return rec


def write_adversarial_file(
    path: str,
    n: int,
    kind: str,
    *,
    seed: int = 0,
    chunk: int = 1_000_000,
) -> None:
    """Stream ``n`` hostile records to ``path`` (chunked)."""
    with open(path, "wb") as f:
        done = 0
        while done < n:
            m = min(chunk, n - done)
            f.write(
                make_adversarial_records(
                    m, kind, seed=seed + done, start_idx=done
                ).tobytes()
            )
            done += m


def make_records(
    n: int, *, skewed: bool = False, seed: int = 0, start_idx: int = 0
) -> np.ndarray:
    """(n, 100) uint8 records; payload begins with the 8-byte record id so
    that validators can detect loss/duplication."""
    keys = (
        skewed_keys(n, seed, start_idx) if skewed else uniform_keys(n, seed)
    )
    rec = np.empty((n, RECORD_BYTES), dtype=np.uint8)
    rec[:, :KEY_BYTES] = keys
    ids = (np.arange(start_idx, start_idx + n, dtype=np.uint64)).view(
        np.uint8
    ).reshape(n, 8)
    rec[:, KEY_BYTES : KEY_BYTES + 8] = ids
    filler = _rng(seed + 1).integers(
        ASCII_LO, ASCII_HI + 1, size=(n, PAYLOAD_BYTES - 8), dtype=np.uint8
    )
    rec[:, KEY_BYTES + 8 :] = filler
    return rec


def write_file(
    path: str,
    n: int,
    *,
    skewed: bool = False,
    seed: int = 0,
    chunk: int = 1_000_000,
) -> None:
    """Stream ``n`` records to ``path`` (chunked; supports > memory sizes)."""
    with open(path, "wb") as f:
        done = 0
        while done < n:
            m = min(chunk, n - done)
            f.write(
                make_records(
                    m, skewed=skewed, seed=seed + done, start_idx=done
                ).tobytes()
            )
            done += m


def read_records(path: str, mmap: bool = True) -> np.ndarray:
    """Memory-mapped (n, 100) view of a record file.

    Raises ``ValueError`` when the file size is not a whole number of
    records — a truncated or mis-formatted file must never be silently
    shortened (the dropped tail would look like a successful sort that
    lost records).
    """
    arr = np.memmap(path, dtype=np.uint8, mode="r")
    if arr.shape[0] % RECORD_BYTES:
        raise ValueError(
            f"{path!r} is {arr.shape[0]} bytes — not a multiple of the "
            f"{RECORD_BYTES}-byte record size; refusing to drop the "
            f"trailing {arr.shape[0] % RECORD_BYTES} bytes"
        )
    arr = arr.reshape(-1, RECORD_BYTES)
    return arr if mmap else np.array(arr)
