"""The least bytes of the full-key encode kernel's work
(``csrc/encode.cu`` ``encode_full_kernel``), as :mod:`roofline` counts
every kernel's: each key byte read once and each of the three words of
a key written once, at its least width (a 32-bit word)."""

from __future__ import annotations

from perfbench import roofline

FULL_WORDS_BYTES = roofline.KEY_WORD_BYTES + 4  # hi, lo and the tail word


def encode_full_bytes(n: int, key_bytes: int) -> int:
    """Full-key encode of ``n`` keys of ``key_bytes`` bytes: the key bytes
    in, three words out."""
    return n * (key_bytes + FULL_WORDS_BYTES)
