"""Bitonic kernel: sort each row of ``(R, C)`` ``(hi, lo, val)`` arrays.

Replaces ``src/repro/kernels/bitonic.py:sort_rows_pallas``.  The CUDA
source is ``csrc/bitonic.cu``; its note says what bounds the kernel
(memory at the main path's widths: 20 bytes a slot read and written
once, every stage on shared memory) and how the design meets it (one
block per row, the row packed into 12 bytes a slot of shared memory).

The order is strict on ``(hi, lo, val)``, so the result is unique:
:func:`sort_rows_plain` computes it with two stable PyTorch sorts and is
the version the kernel is held against, bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.core.encoding import packed_key
from repro_torch.kernels import build

SOURCE = "src/repro_torch/csrc/bitonic.cu"
# widest row whose 12 bytes a slot fit the 227 KB of shared memory a
# block may use (a power of two, as the network needs)
MAX_WIDTH = 16384


def sort_rows_plain(
    hi: torch.Tensor, lo: torch.Tensor, val: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rows sorted by ``(hi, lo, val)`` ascending, in plain PyTorch:
    a stable sort by ``val``, then a stable sort by the packed key."""
    by_val = torch.argsort(val, dim=1, stable=True)
    key = packed_key(hi, lo).gather(1, by_val)
    perm = by_val.gather(1, torch.argsort(key, dim=1, stable=True))
    return hi.gather(1, perm), lo.gather(1, perm), val.gather(1, perm)


def sort_rows_cuda(
    hi: torch.Tensor, lo: torch.Tensor, val: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel: ``hi``/``lo`` (R, C) int64, ``val`` (R, C) int32 on a
    CUDA device, C a power of two no wider than :data:`MAX_WIDTH`."""
    if not (hi.is_cuda and lo.is_cuda and val.is_cuda):
        raise ValueError("bitonic kernel needs CUDA tensors")
    if (hi.dtype, lo.dtype, val.dtype) != (torch.int64, torch.int64, torch.int32):
        raise ValueError(
            f"need int64/int64/int32 rows, got {hi.dtype}/{lo.dtype}/{val.dtype}"
        )
    if hi.ndim != 2 or hi.shape != lo.shape or hi.shape != val.shape:
        raise ValueError(
            f"rows must be equal 2-D shapes: {hi.shape}/{lo.shape}/{val.shape}"
        )
    if not (hi.is_contiguous() and lo.is_contiguous() and val.is_contiguous()):
        raise ValueError("rows must be contiguous")
    r, c = hi.shape
    if c & (c - 1) or c > MAX_WIDTH:
        raise ValueError(
            f"row width {c} must be a power of two <= {MAX_WIDTH} "
            "(one row must fit a block's shared memory)"
        )
    hi_o, lo_o, val_o = (torch.empty_like(t) for t in (hi, lo, val))
    lib = build.library()
    with torch.cuda.device(hi.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.repro_sort_rows(
            hi.data_ptr(), lo.data_ptr(), val.data_ptr(),
            hi_o.data_ptr(), lo_o.data_ptr(), val_o.data_ptr(),
            r, c, stream,
        )
    build.check(code, "bitonic kernel")
    return hi_o, lo_o, val_o
