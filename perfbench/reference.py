"""The plain reference of the learned device sort, and its check.

The configuration's guarantees (``guarantees`` in each configuration
file) define one answer for each input: the records ordered by their
first 8 key bytes compared as unsigned bytes, ties in input order.  The
answer is ``(hi, lo, perm)``: ``perm[i]`` the input position of output
record ``i``, ``hi``/``lo`` the big-endian words of its first 8 key
bytes.

:func:`check` counts, in blocks of rows, how far an answer is from that
one, with nothing but the raw key bytes the harness made: positions not
named exactly once, words that are not the named record's, neighbours
out of order, and equal neighbours out of input order.  All four are 0
exactly when the answer equals the reference's stable sort, which
:func:`stable_sort` computes (the tests hold the two against each
other).  Plain PyTorch; nothing of the program is imported.
"""

from __future__ import annotations

import torch

LIMITS = {"perm_bad": 0, "words_bad": 0, "order_bad": 0, "ties_bad": 0}
BLOCK_ROWS = 1 << 24


def encode_words(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, k) uint8 keys -> the big-endian words of their first 8 bytes
    (shorter keys read as zero-padded), as int64."""
    k = keys[:, :8].to(torch.int64)
    if k.shape[1] < 8:
        k = torch.nn.functional.pad(k, (0, 8 - k.shape[1]))
    hi = torch.zeros(k.shape[0], dtype=torch.int64, device=keys.device)
    lo = torch.zeros_like(hi)
    for b in range(4):
        hi = hi * 256 + k[:, b]
        lo = lo * 256 + k[:, 4 + b]
    return hi, lo


def stable_sort(
    keys: torch.Tensor, key: str = "u64"
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference answer ``(hi, lo, perm)``.  ``key`` is the key the
    order is computed on: ``u64`` the exact 8 bytes (the reference);
    ``f64`` the 8 bytes rounded to a float64 and ``hi32`` the first 4
    bytes alone (the controls, which break the configuration's order)."""
    hi, lo = encode_words(keys)
    if key == "u64":
        # least significant word first: a stable sort keeps its order
        perm = torch.sort(lo, stable=True).indices
        perm = perm[torch.sort(hi[perm], stable=True).indices]
    elif key == "f64":
        k = hi.to(torch.float64) * 4294967296.0 + lo.to(torch.float64)
        perm = torch.sort(k, stable=True).indices
    elif key == "hi32":
        perm = torch.sort(hi, stable=True).indices
    else:
        raise ValueError(f"unknown key {key!r}")
    return hi[perm], lo[perm], perm.to(torch.int32)


def check(
    keys: torch.Tensor,
    hi_s: torch.Tensor,
    lo_s: torch.Tensor,
    perm: torch.Tensor,
    block: int = BLOCK_ROWS,
) -> dict[str, int]:
    """How far ``(hi_s, lo_s, perm)`` is from the reference answer for
    ``keys``; every count 0 means equal.  An answer of the wrong length
    counts each missing or extra row as bad."""
    n = keys.shape[0]
    m = min(n, perm.shape[0], hi_s.shape[0], lo_s.shape[0])
    bad = dict.fromkeys(LIMITS, 0)
    bad["perm_bad"] = abs(perm.shape[0] - n)
    bad["words_bad"] = abs(hi_s.shape[0] - n) + abs(lo_s.shape[0] - n)
    seen = torch.zeros(n, dtype=torch.int32, device=keys.device)
    prev = None  # (hi, lo, perm) of the previous block's last row
    for b0 in range(0, m, block):
        b1 = min(b0 + block, m)
        p = perm[b0:b1].to(torch.int64)
        inside = (p >= 0) & (p < n)
        bad["perm_bad"] += int((~inside).sum())
        p = torch.where(inside, p, 0)
        seen.index_add_(0, p[inside], torch.ones_like(p[inside], dtype=torch.int32))
        h, l = encode_words(keys[p])
        bad["words_bad"] += int(
            ((h != hi_s[b0:b1].to(torch.int64)) | (l != lo_s[b0:b1].to(torch.int64))).sum()
        )
        if prev is not None:
            h = torch.cat([prev[0], h])
            l = torch.cat([prev[1], l])
            p = torch.cat([prev[2], p])
        same = (h[:-1] == h[1:]) & (l[:-1] == l[1:])
        down = (h[:-1] > h[1:]) | ((h[:-1] == h[1:]) & (l[:-1] > l[1:]))
        bad["order_bad"] += int(down.sum())
        bad["ties_bad"] += int((same & (p[:-1] > p[1:])).sum())
        prev = (h[-1:], l[-1:], p[-1:])
    # every position named exactly once; one named twice leaves another
    # unnamed, so it counts twice
    bad["perm_bad"] += int((seen != 1).sum())
    return bad
