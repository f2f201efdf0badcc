"""A gensort ``-a`` record file, made on the device from a seed and
written to disk: the input of the file-sort driver.

Record ``i`` of an ``n``-record file is gensort's ASCII layout
(ordinal.com/gensort.html, ``-a``), 100 bytes:

* bytes 0-9: the key, by :mod:`gensort_keys`'s rule for record ``i``
  (printable ASCII; under ``-s`` its first 6 bytes from the skew table by
  ``floor(log2(i)) mod 128``);
* bytes 10-11: two spaces;
* bytes 12-43: ``i`` in 32 upper-case hex digits, so every record of
  the file is unique and a lost or doubled record can be counted;
* bytes 44-45: two spaces;
* bytes 46-97: filler, 13 hex digits each written 4 times;
* bytes 98-99: CR LF.

The key bytes the rule does not fix and the filler are drawn from the
run's seed, :data:`CHUNK` records a call of the generator, so one seed
always gives the same file.  Nothing of the program is imported.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from perfbench import gensort_keys

RECORD_BYTES, KEY_BYTES = 100, 10
RECNUM_AT, RECNUM_DIGITS = 12, 32
FILLER_AT, FILLER_DIGITS, FILLER_REPEAT = 46, 13, 4
CHUNK = 1 << 20  # records made and written at a time
_HEX = b"0123456789ABCDEF"


def device_seed(seed: int) -> int:
    """The generator's seed for a run's ``--seed`` (any whole number)."""
    rng = np.random.default_rng(np.random.SeedSequence(seed % 2**64))
    return int(rng.integers(0, 2**63))


def records(idx: torch.Tensor, cfg: dict, gen: torch.Generator) -> torch.Tensor:
    """(n, 100) uint8 records of the file's records ``idx`` (int64)."""
    if cfg["record_bytes"] != RECORD_BYTES or cfg["key_bytes"] != KEY_BYTES:
        raise ValueError("gensort -a records are 100 bytes with a 10-byte key")
    n, dev = idx.shape[0], idx.device
    hexd = torch.tensor(list(_HEX), dtype=torch.uint8, device=dev)
    rec = torch.empty((n, RECORD_BYTES), dtype=torch.uint8, device=dev)
    rec[:, :KEY_BYTES] = gensort_keys.keys_at(idx, cfg, gen)
    rec[:, KEY_BYTES:RECNUM_AT] = ord(" ")
    # 32 hex digits, most significant first; the top 16 of an int64 are 0
    shifts = torch.arange(60, -1, -4, device=dev)
    rec[:, RECNUM_AT : RECNUM_AT + 16] = ord("0")
    rec[:, RECNUM_AT + 16 : RECNUM_AT + RECNUM_DIGITS] = hexd[(idx[:, None] >> shifts) & 15]
    rec[:, 44:46] = ord(" ")
    nib = torch.randint(0, 16, (n, FILLER_DIGITS), generator=gen, device=dev)
    rec[:, FILLER_AT : FILLER_AT + FILLER_DIGITS * FILLER_REPEAT] = (
        hexd[nib].repeat_interleave(FILLER_REPEAT, dim=1))
    rec[:, 98] = ord("\r")
    rec[:, 99] = ord("\n")
    return rec


def write(path, cfg: dict, seed: int, device) -> int:
    """Write the configuration's ``file_records``-record file to ``path``
    from ``seed`` and fsync it; returns the number of records."""
    n = int(cfg["file_records"])
    gen = torch.Generator(device=device)
    gen.manual_seed(device_seed(seed))
    with open(path, "wb") as f:
        for s in range(0, n, CHUNK):
            idx = torch.arange(s, min(n, s + CHUNK), dtype=torch.int64, device=device)
            f.write(records(idx, cfg, gen).cpu().numpy().tobytes())
        f.flush()
        os.fsync(f.fileno())
    return n
