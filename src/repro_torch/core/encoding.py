"""Numeric embedding of ASCII keys (paper §4) for the PyTorch port.

Port of ``src/repro/core/encoding.py``.  The first 8 key bytes pack
big-endian into a ``(hi, lo)`` pair of unsigned 32-bit words, which is
order-equivalent to memcmp over those bytes (DESIGN.md §2).

PyTorch on the CPU implements neither ``<<`` nor ``-`` nor ``<`` for
``uint32``, so the port carries every word **zero-extended in int64**:
values lie in ``[0, 2**32)`` and compare, subtract and shift as the
unsigned words do.  ``SENTINEL`` (``0xFFFFFFFF``) still sorts after every
real key.  The NumPy functions (``encode_np``, ``feature_f64_np``,
``ascii_digits``) are copies of the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

# Number of key bytes captured numerically by the (hi, lo) embedding.
ENCODED_BYTES = 8

# Sorts after every real key (keys are printable ASCII < 0x80, so a
# 0xFFFFFFFF word is never produced by ``encode``).
SENTINEL = 0xFFFFFFFF

_MASK32 = 0xFFFFFFFF


def ascii_digits(values: np.ndarray, width: int) -> np.ndarray:
    """(m, width) uint8 zero-padded ASCII decimal rendering of
    non-negative int64 values.  ``width`` must be <= 19."""
    v = np.asarray(values, dtype=np.int64)
    if width > 19:
        raise ValueError(f"width {width} exceeds int64 decimal range")
    if v.size and int(v.min()) < 0:
        raise ValueError("ascii_digits requires non-negative values")
    if width < 19 and v.size and int(v.max()) >= 10**width:
        raise ValueError(
            f"value {int(v.max())} does not fit {width} decimal digits"
        )
    pow10 = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    return ((v[:, None] // pow10) % 10 + ord("0")).astype(np.uint8)


def encode(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(N, K) uint8`` keys -> ``(hi, lo)`` int64-carried u32 words.

    Keys shorter than 8 bytes are zero-padded, longer ones truncated to
    the 8 encoded bytes (the paper sets ``ASCII(x_i) = 0`` past the key
    end, §4)."""
    n, width = keys.shape
    k = keys[:, :ENCODED_BYTES].to(torch.int64)
    if width < ENCODED_BYTES:
        k = torch.nn.functional.pad(k, (0, ENCODED_BYTES - width))
    hi = (k[:, 0] << 24) | (k[:, 1] << 16) | (k[:, 2] << 8) | k[:, 3]
    lo = (k[:, 4] << 24) | (k[:, 5] << 16) | (k[:, 6] << 8) | k[:, 7]
    return hi, lo


def packed_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """One signed int64 key per ``(hi, lo)`` pair whose order is the
    unsigned order of the word pair (``torch.sort`` takes one key).
    ``(hi - 2**31) * 2**32 + lo`` stays inside int64, unlike a shift of
    ``hi`` into the sign bit."""
    return (hi - 2**31) * 2**32 + lo


def encode_np(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """NumPy twin of :func:`encode` for the host-side (file) pipeline:
    ``uint32`` words, as the reference returns them."""
    k = keys.astype(np.uint32)
    n, width = keys.shape
    if width < ENCODED_BYTES:
        k = np.concatenate(
            [k, np.zeros((n, ENCODED_BYTES - width), dtype=np.uint32)], axis=1
        )
    hi = (k[:, 0] << 24) | (k[:, 1] << 16) | (k[:, 2] << 8) | k[:, 3]
    lo = (k[:, 4] << 24) | (k[:, 5] << 16) | (k[:, 6] << 8) | k[:, 7]
    return hi, lo


def feature_f32(
    hi: torch.Tensor,
    lo: torch.Tensor,
    min_hi,
    min_lo,
    inv_range,
) -> torch.Tensor:
    """Map ``(hi, lo)`` to a normalised f32 feature in [0, 1].

    The subtract happens on the integer words, with borrow, before the
    float conversion, so keys with a long shared prefix keep the
    precision of ``lo``.  The borrow subtract runs on int64-carried
    words and is masked back to 32 bits (the reference's u32 wrap).
    Every float step is its own rounded operation, so nothing is
    contracted into a fused multiply-add."""
    below = (hi < min_hi) | ((hi == min_hi) & (lo < min_lo))
    borrow = (lo < min_lo).to(torch.int64)
    dlo = (lo - min_lo) & _MASK32
    dhi = (hi - min_hi - borrow) & _MASK32
    x = dhi.to(torch.float32) * 4294967296.0 + dlo.to(torch.float32)
    x = torch.clamp(x * inv_range, 0.0, 1.0)
    return torch.where(below, torch.zeros_like(x), x)


def feature_f64_np(
    hi: np.ndarray, lo: np.ndarray, min_hi: int, min_lo: int, inv_range: float
) -> np.ndarray:
    """Float64 twin of :func:`feature_f32` used when *fitting* the model."""
    below = (hi < np.uint32(min_hi)) | (
        (hi == np.uint32(min_hi)) & (lo < np.uint32(min_lo))
    )
    borrow = (lo < np.uint32(min_lo)).astype(np.uint64)
    dlo = (lo - np.uint32(min_lo)).astype(np.uint64)
    dhi = (hi.astype(np.uint64) - np.uint64(min_hi) - borrow) & np.uint64(
        0xFFFFFFFF
    )
    x = dhi.astype(np.float64) * 4294967296.0 + dlo.astype(np.float64)
    return np.where(below, 0.0, np.clip(x * inv_range, 0.0, 1.0))
