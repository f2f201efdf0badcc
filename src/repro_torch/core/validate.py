"""valsort-equivalent output validation (paper §7.1 methodology):

Copy of ``src/repro/core/validate.py`` for the PyTorch port.
sortedness in memcmp order + content checksum + record conservation.

Two views, one contract:

* the historical **matrix path** (``keys_view`` / ``is_sorted`` /
  ``checksum`` / ``validate`` / ``validate_file``) over fixed-stride
  ``(n, record_bytes)`` arrays — unchanged semantics and checksum values;
* the **block path** (``*_block`` functions and ``validate_file`` with a
  ``fmt=``) over :class:`repro_torch.core.format.RecordBlock`, which validates
  any record layout through the offsets view: sortedness over the
  zero-padded key window, an order-invariant content checksum that
  weights every byte by its in-record position (so it also conserves
  record *lengths*, not just the byte multiset), and the record count.
"""

from __future__ import annotations

import numpy as np

from repro_torch.data import gensort

_FNV = np.uint64(1099511628211)


def keys_view(
    records: np.ndarray, key_bytes: int = gensort.KEY_BYTES
) -> np.ndarray:
    """Byte-string view of the keys for vectorized memcmp comparison."""
    keys = np.ascontiguousarray(records[:, :key_bytes])
    return keys.view([("k", f"S{key_bytes}")])["k"].reshape(-1)


def is_sorted(records: np.ndarray) -> bool:
    k = keys_view(records)
    return bool((k[:-1] <= k[1:]).all())


def checksum(records: np.ndarray) -> int:
    """Order-invariant content checksum (sum of per-record FNV-ish hashes)."""
    x = records.astype(np.uint64)
    weights = (
        np.arange(1, records.shape[1] + 1, dtype=np.uint64) * _FNV
    )
    per_record = (x * weights[None, :]).sum(axis=1, dtype=np.uint64)
    per_record = per_record ^ (per_record >> np.uint64(13))
    return int(per_record.sum(dtype=np.uint64))


def validate(
    output: np.ndarray, reference_checksum: int, n_expected: int
) -> dict[str, bool]:
    res = {
        "sorted": is_sorted(output),
        "count_ok": output.shape[0] == n_expected,
        "checksum_ok": checksum(output) == reference_checksum,
    }
    res["ok"] = all(res.values())
    return res


# ---------------------------------------------------------------------------
# Block (offsets-view) path — any record format
# ---------------------------------------------------------------------------


def block_keys_view(block) -> np.ndarray:
    """|S{key_width}| view of a block's zero-padded key prefixes."""
    keys = np.ascontiguousarray(block.keys)
    return keys.view([("k", f"S{keys.shape[1]}")])["k"].reshape(-1)


def is_sorted_block(block) -> bool:
    """Non-decreasing memcmp order over the key window.  Ties beyond the
    window are unordered by construction (the sort is stable on them)."""
    k = block_keys_view(block)
    return bool((k[:-1] <= k[1:]).all())


def checksum_block(block) -> int:
    """Order-invariant checksum over the offsets view.

    Every byte is weighted by its 1-based position *within its record*
    (one ``np.add.reduceat`` per file — no per-record Python loop), then
    mixed with the record length, so reordering records never changes
    the sum but moving a byte across a record boundary, corrupting a
    byte, or splitting/merging records does.
    """
    n = block.n_records
    if n == 0:
        return 0
    data = np.asarray(block.data[: block.n_bytes], dtype=np.uint64)
    offsets = np.asarray(block.offsets, dtype=np.int64)
    lengths = np.diff(offsets)
    rel = np.arange(data.shape[0], dtype=np.uint64) - np.repeat(
        offsets[:-1], lengths
    ).astype(np.uint64)
    per_record = np.add.reduceat(data * ((rel + np.uint64(1)) * _FNV), offsets[:-1])
    per_record = per_record + lengths.astype(np.uint64) * np.uint64(0x9E3779B1)
    per_record = per_record ^ (per_record >> np.uint64(13))
    return int(per_record.sum(dtype=np.uint64))


def validate_block(
    block, reference_checksum: int, n_expected: int
) -> dict[str, bool]:
    """Sortedness + checksum + record conservation over the offsets view."""
    res = {
        "sorted": is_sorted_block(block),
        "count_ok": block.n_records == n_expected,
        "checksum_ok": checksum_block(block) == reference_checksum,
    }
    res["ok"] = all(res.values())
    return res


def validate_file(
    out_path: str, reference_checksum: int, n_expected: int, fmt=None
):
    """Validate a sorted output file.

    Without ``fmt`` this is the historical gensort path (matrix checksum
    — values unchanged).  With a format the file is read through its
    offsets view and ``reference_checksum`` must come from
    ``checksum_block`` over the same format's view of the input.
    """
    if fmt is None:
        recs = gensort.read_records(out_path)
        return validate(recs, reference_checksum, n_expected)
    block = fmt.read_block(out_path)
    return validate_block(block, reference_checksum, n_expected)
