"""The plain reference of the full-key device sort.

From raw key bytes alone, ``(N, K)`` uint8 with ``K <= 12``, it computes
the answer ``sort_device(model, hi, lo, tail)`` must give: the words of
each key (bytes 0-3, 4-7 and 8-11, big-endian, zero-padded past the
key's end, carried zero-extended in int64) and the permutation of the
stable memcmp order of the whole key.  The words are made block by
block; the order is three stable sorts, least significant word first
(tail, then ``lo``, then ``hi``), so equal keys keep their input order.

Plain ``torch`` only: no kernel, no other module of the port, no JAX.
"""

from __future__ import annotations

import torch

WORD_BYTES = 4
MAX_KEY_BYTES = 3 * WORD_BYTES
BLOCK_ROWS = 1 << 20


def words(keys: torch.Tensor, block: int = BLOCK_ROWS) -> tuple[torch.Tensor, ...]:
    """``(hi, lo, tail)`` int64 words of ``(N, K)`` uint8 keys, K <= 12."""
    n, k = keys.shape
    if k > MAX_KEY_BYTES:
        raise ValueError(f"keys of {k} bytes: the reference orders at most {MAX_KEY_BYTES}")
    out = tuple(torch.zeros(n, dtype=torch.int64, device=keys.device) for _ in range(3))
    for b0 in range(0, n, block):
        b1 = min(b0 + block, n)
        kb = keys[b0:b1].to(torch.int64)
        for w, word in enumerate(out):
            v = word[b0:b1]
            for b in range(w * WORD_BYTES, (w + 1) * WORD_BYTES):
                v.mul_(256)
                if b < k:
                    v.add_(kb[:, b])
    return out


def full_key_sort(keys: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """``(hi, lo, tail, perm)``: the sorted words and the int32
    permutation of the stable memcmp order of ``keys``."""
    hi, lo, tail = words(keys)
    perm = torch.sort(tail, stable=True).indices
    perm = perm[torch.sort(lo[perm], stable=True).indices]
    perm = perm[torch.sort(hi[perm], stable=True).indices]
    return hi[perm], lo[perm], tail[perm], perm.to(torch.int32)
