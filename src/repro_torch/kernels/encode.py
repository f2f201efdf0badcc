"""Encode kernel: ``(N, 8)`` uint8 key prefixes -> ``(hi, lo)`` words.

Replaces ``src/repro/kernels/encode.py:encode_pallas``.  The CUDA source
is ``csrc/encode.cu``; its note says what bounds the kernel (memory: 8
bytes read and 16 written per record) and how the design meets it (one
8-byte load and two byte swaps per thread).  :func:`encode_plain` is the
plain PyTorch version it is held against.
"""

from __future__ import annotations

import torch

from repro_torch.core import encoding
from repro_torch.kernels import build

SOURCE = "src/repro_torch/csrc/encode.cu"


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
