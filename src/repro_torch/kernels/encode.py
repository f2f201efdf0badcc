"""Encode kernels: ``(N, 8)`` uint8 key prefixes -> ``(hi, lo)`` words,
and ``(N, K)`` keys, ``K <= 12``, -> ``(hi, lo, tail)`` words.

Replaces ``src/repro/kernels/encode.py:encode_pallas``.  The CUDA source
is ``csrc/encode.cu``; its note says what bounds the kernel (memory: 8
bytes read and 16 written per record) and how the design meets it (one
8-byte load and two byte swaps per thread).  :func:`encode_plain` is the
plain PyTorch version it is held against.

The full-key kernel (``encode_full_kernel``, same source) reads each row
at the array's own stride (at most :data:`MAX_STRIDE` bytes), so a
slice of 10-byte keys needs no copy; :func:`encode_full_plain` is its
plain version.
"""

from __future__ import annotations

import torch

from repro_torch.core import encoding
from repro_torch.kernels import build

SOURCE = "src/repro_torch/csrc/encode.cu"
# widest row stride the full-key kernel stages in shared memory (kMaxStride)
MAX_STRIDE = 16


def encode_plain(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, 8) uint8 -> (hi, lo) int64-carried u32, in plain PyTorch."""
    return encoding.encode(keys)


def encode_cuda(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, 8) uint8 on a CUDA device -> (hi, lo) int64, by the kernel."""
    if not keys.is_cuda:
        raise ValueError(f"encode kernel needs a CUDA tensor, got {keys.device}")
    if keys.dtype != torch.uint8 or keys.ndim != 2:
        raise ValueError(f"keys must be (N, 8) uint8, got {keys.dtype} {tuple(keys.shape)}")
    if keys.shape[1] != encoding.ENCODED_BYTES:
        raise ValueError(f"pad keys to {encoding.ENCODED_BYTES} bytes first")
    if not keys.is_contiguous() or keys.data_ptr() % 8:
        raise ValueError("keys must be contiguous and 8-byte aligned")
    n = keys.shape[0]
    hi = torch.empty(n, dtype=torch.int64, device=keys.device)
    lo = torch.empty(n, dtype=torch.int64, device=keys.device)
    lib = build.library()
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.repro_encode(
            keys.data_ptr(), hi.data_ptr(), lo.data_ptr(), n, stream
        )
    build.check(code, "encode kernel")
    return hi, lo


def encode_full_plain(
    keys: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(N, K) uint8, K <= 12 -> (hi, lo, tail) int64-carried u32, in
    plain PyTorch."""
    return (*encoding.encode(keys), encoding.encode_tail(keys))


def row_stride(keys: torch.Tensor) -> "int | None":
    """The bytes between the rows of ``(N, K)`` keys that the full-key
    kernel reads in place, or None where it cannot: a row that is not
    contiguous, or rows closer than K or further than
    :data:`MAX_STRIDE` bytes apart."""
    n, k = keys.shape
    if n <= 1:
        return k
    if k > 1 and keys.stride(1) != 1:
        return None
    return keys.stride(0) if k <= keys.stride(0) <= MAX_STRIDE else None


def encode_full_cuda(
    keys: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(N, K) uint8 rows on a CUDA device, K <= 12, each row contiguous
    and ``K <= keys.stride(0) <=`` :data:`MAX_STRIDE` -> (hi, lo, tail)
    int64, by the kernel."""
    if not keys.is_cuda:
        raise ValueError(f"encode kernel needs a CUDA tensor, got {keys.device}")
    if keys.dtype != torch.uint8 or keys.ndim != 2:
        raise ValueError(f"keys must be (N, K) uint8, got {keys.dtype} {tuple(keys.shape)}")
    n, k = keys.shape
    if k > encoding.FULL_KEY_BYTES:
        raise ValueError(f"keys of {k} bytes: at most {encoding.FULL_KEY_BYTES}")
    stride = row_stride(keys)
    if stride is None:
        raise ValueError(f"rows must be contiguous, {k} to {MAX_STRIDE} bytes apart; "
                         f"got strides {keys.stride()}")
    hi, lo, tail = (torch.empty(n, dtype=torch.int64, device=keys.device) for _ in range(3))
    lib = build.library()
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.repro_encode_full(
            keys.data_ptr(), stride, k, hi.data_ptr(), lo.data_ptr(), tail.data_ptr(),
            n, stream,
        )
    build.check(code, "full-key encode kernel")
    return hi, lo, tail
