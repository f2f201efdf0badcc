"""The plain reference of the full-key device sort, and its check.

The configuration's guarantees (``configs/gensort-skew-valsort.json``)
define one answer for each input: the records ordered by their whole
key, up to 12 bytes, compared as unsigned bytes (memcmp), as valsort
checks gensort's 10-byte key; equal keys in input order.  The answer is
``(hi, lo, tail, perm)``: ``perm[i]`` the input position of output
record ``i``, ``hi``, ``lo`` and ``tail`` the big-endian words of its
key bytes 0-3, 4-7 and 8-11, zero-padded past the key's end.

:func:`check` counts, in blocks of rows, how far an answer is from that
one, with nothing but the raw key bytes the driver made: positions not
named exactly once, words that are not the named record's (all three),
neighbours out of order by the whole key, and equal neighbours out of
input order.  All four are 0 exactly when the answer equals the
reference's stable sort, which :func:`stable_sort` computes (the tests
hold the two against each other).  Plain PyTorch; nothing of the program
is imported.
"""

from __future__ import annotations

import torch

LIMITS = {"perm_bad": 0, "words_bad": 0, "order_bad": 0, "ties_bad": 0}
BLOCK_ROWS = 1 << 24
KEY_BYTES_MAX = 12


def encode_words(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(n, k) uint8 keys, k <= 12 -> the big-endian words of key bytes
    0-3, 4-7 and 8-11 (zero-padded past the key's end), as int64."""
    if keys.shape[1] > KEY_BYTES_MAX:
        raise ValueError(f"keys of {keys.shape[1]} bytes: at most {KEY_BYTES_MAX}")
    k = torch.nn.functional.pad(keys.to(torch.int64), (0, KEY_BYTES_MAX - keys.shape[1]))
    out = []
    for w in range(3):
        v = torch.zeros(k.shape[0], dtype=torch.int64, device=keys.device)
        for b in range(4 * w, 4 * w + 4):
            v = v * 256 + k[:, b]
        out.append(v)
    return tuple(out)


def stable_sort(keys: torch.Tensor, key: str = "u96") -> tuple[torch.Tensor, ...]:
    """The reference answer ``(hi, lo, tail, perm)``.  ``key`` is the key
    the order is computed on: ``u96`` the exact three words (the
    reference: stable passes, least significant word first); ``f64`` the
    tail, then the first 8 bytes rounded to a float64 (a control, which
    breaks the configuration's order)."""
    hi, lo, tail = encode_words(keys)
    perm = torch.sort(tail, stable=True).indices
    if key == "u96":
        perm = perm[torch.sort(lo[perm], stable=True).indices]
        perm = perm[torch.sort(hi[perm], stable=True).indices]
    elif key == "f64":
        k = hi.to(torch.float64) * 4294967296.0 + lo.to(torch.float64)
        perm = perm[torch.sort(k[perm], stable=True).indices]
    else:
        raise ValueError(f"unknown key {key!r}")
    return hi[perm], lo[perm], tail[perm], perm.to(torch.int32)


def check(
    keys: torch.Tensor,
    hi_s: torch.Tensor,
    lo_s: torch.Tensor,
    tail_s: torch.Tensor,
    perm: torch.Tensor,
    block: int = BLOCK_ROWS,
) -> dict[str, int]:
    """How far ``(hi_s, lo_s, tail_s, perm)`` is from the reference answer
    for ``keys``; every count 0 means equal.  An answer of the wrong
    length counts each missing or extra row as bad."""
    n = keys.shape[0]
    got = (hi_s, lo_s, tail_s)
    m = min(n, perm.shape[0], *(x.shape[0] for x in got))
    bad = dict.fromkeys(LIMITS, 0)
    bad["perm_bad"] = abs(perm.shape[0] - n)
    bad["words_bad"] = sum(abs(x.shape[0] - n) for x in got)
    seen = torch.zeros(n, dtype=torch.int32, device=keys.device)
    prev = None  # (hi, lo, tail, perm) of the previous block's last row
    for b0 in range(0, m, block):
        b1 = min(b0 + block, m)
        p = perm[b0:b1].to(torch.int64)
        inside = (p >= 0) & (p < n)
        bad["perm_bad"] += int((~inside).sum())
        p = torch.where(inside, p, 0)
        seen.index_add_(0, p[inside], torch.ones_like(p[inside], dtype=torch.int32))
        w = encode_words(keys[p])
        wrong = torch.zeros(b1 - b0, dtype=torch.bool, device=keys.device)
        for mine, theirs in zip(w, got):
            wrong |= mine != theirs[b0:b1].to(torch.int64)
        bad["words_bad"] += int(wrong.sum())
        h, l, t = w
        if prev is not None:
            h, l, t, p = (torch.cat([a, b]) for a, b in zip(prev, (h, l, t, p)))
        eq_h, eq_l = h[:-1] == h[1:], l[:-1] == l[1:]
        same = eq_h & eq_l & (t[:-1] == t[1:])
        down = (h[:-1] > h[1:]) | (eq_h & ((l[:-1] > l[1:]) | (eq_l & (t[:-1] > t[1:]))))
        bad["order_bad"] += int(down.sum())
        bad["ties_bad"] += int((same & (p[:-1] > p[1:])).sum())
        prev = (h[-1:], l[-1:], t[-1:], p[-1:])
    # every position named exactly once; one named twice leaves another
    # unnamed, so it counts twice
    bad["perm_bad"] += int((seen != 1).sum())
    return bad
