"""Histogram kernel: per-bucket counts of ``(N,)`` int32 bucket ids.

Replaces ``src/repro/kernels/histogram.py:histogram_pallas``.  The CUDA
source is ``csrc/histogram.cu``; its note says what bounds the kernel
(memory: 4 bytes read per id, 4 written per bin) and its two strategies
(a private histogram per block in shared memory where the bins fit,
global atomics where they do not).  :func:`histogram_plain` is the plain
PyTorch version it is held against, bit for bit.

Both count what the reference's wrapper and kernel count together: an
id outside ``[0, n_buckets)`` never counts (the reference pads with -1,
which its one-hot compare never matches).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

SOURCE = "src/repro_torch/csrc/histogram.cu"


def histogram_plain(ids: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """(n_buckets,) int32 counts of the in-range ids, in plain PyTorch:
    out-of-range ids go to one extra slot that is sliced off (no
    boolean mask, so nothing waits on the device)."""
    ids = ids.to(torch.int64)
    keep = (ids >= 0) & (ids < n_buckets)
    slot = torch.where(keep, ids, n_buckets)
    counts = torch.zeros(n_buckets + 1, dtype=torch.int64, device=ids.device)
    counts.scatter_add_(0, slot, torch.ones_like(slot))
    return counts[:n_buckets].to(torch.int32)


def shared_max_bins() -> int:
    """Most bins the shared-memory strategy takes on the current device
    (the shared memory a block can opt into, over 4 bytes a bin)."""
    bins = ctypes.c_int(0)
    build.check(
        build.library().repro_histogram_shared_bins(ctypes.byref(bins)),
        "histogram kernel",
    )
    return bins.value


def histogram_cuda(ids: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """(n_buckets,) int32 counts of the in-range ids, by the kernel."""
    if not ids.is_cuda:
        raise ValueError(f"histogram kernel needs a CUDA tensor, got {ids.device}")
    if ids.dtype != torch.int32 or ids.ndim != 1:
        raise ValueError(f"ids must be (N,) int32, got {ids.dtype} {tuple(ids.shape)}")
    if not ids.is_contiguous():
        raise ValueError("ids must be contiguous")
    if not 1 <= n_buckets < 2**31:
        raise ValueError(f"n_buckets {n_buckets} outside [1, 2**31)")
    out = torch.empty(n_buckets, dtype=torch.int32, device=ids.device)
    lib = build.library()
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.repro_histogram(
            ids.data_ptr(), ids.shape[0], int(n_buckets), out.data_ptr(), stream
        )
    build.check(code, "histogram kernel")
    return out
