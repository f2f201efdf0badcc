"""The plain reference of the file sort, and its check: valsort's
questions, answered exactly, byte for byte.

The configuration's guarantees define one output for each input file:
its records, each once, ordered by their ``key_bytes`` key bytes
compared as unsigned bytes (memcmp), records with equal keys in input
order.  :class:`Reference` reads the input, computes that output by
stable sorts of the key's big-endian words (least significant first),
and :meth:`Reference.check` counts, each with limit 0, how far a sorted
file is from it:

* ``size_bad``: bytes by which the file's length differs from the input's;
* ``perm_bad``: record numbers (gensort ``-a`` bytes 12-43) not in the
  input's range, missing or doubled (one doubled record that overwrote
  another counts 2);
* ``order_bad``: neighbours out of memcmp order;
* ``ties_bad``: positions whose record is not the reference's but has
  its key (equal keys out of input order);
* ``bytes_bad``: positions whose record differs from the reference's in
  any byte, and each record missing or extra.

All five read 0 exactly when the file is the stable sort of the input.
Plain PyTorch on the run's device, in blocks of rows; nothing of the
program is imported and nothing it made is read but the file judged.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench import gensort_file

LIMITS = {"size_bad": 0, "perm_bad": 0, "order_bad": 0, "ties_bad": 0, "bytes_bad": 0}
BLOCK_ROWS = 1 << 21


def read_file(path, device) -> tuple[torch.Tensor, int]:
    """The file's whole records as an (n, 100) uint8 tensor on
    ``device``, and the file's length in bytes."""
    raw = np.fromfile(path, dtype=np.uint8)
    n = raw.shape[0] // gensort_file.RECORD_BYTES
    rec = torch.from_numpy(raw[: n * gensort_file.RECORD_BYTES]).view(n, -1)
    return rec.to(device), raw.shape[0]


def key_words(rec: torch.Tensor, key_bytes: int) -> list[torch.Tensor]:
    """The first ``key_bytes`` bytes of each record as big-endian int64
    words of up to 4 bytes, most significant first."""
    words = []
    for s in range(0, key_bytes, 4):
        w = torch.zeros(rec.shape[0], dtype=torch.int64, device=rec.device)
        for b in range(s, min(s + 4, key_bytes)):
            w = w * 256 + rec[:, b].to(torch.int64)
        words.append(w)
    return words


def stable_order(rec: torch.Tensor, key_bytes: int) -> torch.Tensor:
    """Input positions in the stable memcmp order of the first
    ``key_bytes`` key bytes."""
    perm = torch.arange(rec.shape[0], device=rec.device)
    for w in reversed(key_words(rec, key_bytes)):
        perm = perm[torch.sort(w[perm], stable=True).indices]
    return perm


def record_numbers(rec: torch.Tensor) -> torch.Tensor:
    """Each record's number from its 32 hex digits, -1 where they are no
    upper-case hex number below 2**63."""
    at = gensort_file.RECNUM_AT
    d = rec[:, at : at + gensort_file.RECNUM_DIGITS].to(torch.int64)
    val = torch.where((d >= 48) & (d <= 57), d - 48, torch.where((d >= 65) & (d <= 70), d - 55, -1))
    ok = (val >= 0).all(1) & (val[:, :16] == 0).all(1) & (val[:, 16] < 8)
    num = torch.zeros(rec.shape[0], dtype=torch.int64, device=rec.device)
    for i in range(16, gensort_file.RECNUM_DIGITS):
        num = num * 16 + val[:, i].clamp(min=0)
    return torch.where(ok, num, -1)


class Reference:
    """The stable sort of the input file at ``path``, on ``device``."""

    def __init__(self, path, key_bytes: int, device):
        self.key_bytes = key_bytes
        inp, self.size = read_file(path, device)
        self.n = inp.shape[0]
        self.sorted = inp[stable_order(inp, key_bytes)]

    def check(self, path) -> dict[str, int]:
        out, size = read_file(path, self.sorted.device)
        kb, n, m = self.key_bytes, self.n, min(out.shape[0], self.n)
        bad = dict.fromkeys(LIMITS, 0)
        bad["size_bad"] = abs(size - self.size)
        bad["bytes_bad"] = abs(out.shape[0] - n)
        seen = torch.zeros(n, dtype=torch.int32, device=out.device)
        gt = torch.zeros(max(out.shape[0] - 1, 0), dtype=torch.bool, device=out.device)
        eq = torch.ones_like(gt)
        for w in key_words(out, kb):
            gt |= eq & (w[:-1] > w[1:])
            eq &= w[:-1] == w[1:]
        bad["order_bad"] = int(gt.sum())
        for b0 in range(0, out.shape[0], BLOCK_ROWS):
            o = out[b0 : b0 + BLOCK_ROWS]
            num = record_numbers(o)
            inside = (num >= 0) & (num < n)
            bad["perm_bad"] += int((~inside).sum())
            seen.index_add_(0, num[inside], torch.ones_like(num[inside], dtype=torch.int32))
            if b0 < m:
                o, r = o[: m - b0], self.sorted[b0 : min(m, b0 + BLOCK_ROWS)]
                diff = (o != r).any(1)
                bad["bytes_bad"] += int(diff.sum())
                bad["ties_bad"] += int((diff & (o[:, :kb] == r[:, :kb]).all(1)).sum())
        bad["perm_bad"] += int((seen != 1).sum())
        return bad
