"""Bitonic kernel: sort each row of ``(R, C)`` ``(hi, lo, val)`` arrays.

Replaces ``src/repro/kernels/bitonic.py:sort_rows_pallas``.  The CUDA
source is ``csrc/bitonic.cu``; its note says what bounds the kernel
(device memory: 40 bytes a slot read and written once) and how the
design meets it: each thread holds E slots of its row in registers, so
a compare-exchange stage runs in registers when its partner is in the
same thread, by warp shuffles when it is in the same warp, and through
shared memory only when it is in another warp.  :func:`launch_geometry`
chooses the layout for a row width; :func:`stage_split` counts where
the stages run.

The order is strict on ``(hi, lo, val)``, so the result is unique:
:func:`sort_rows_plain` computes it with two stable PyTorch sorts and is
the version the kernel is held against, bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.encoding import packed_key
from repro_torch.kernels import build

SOURCE = "src/repro_torch/csrc/bitonic.cu"
# widest row whose 12 bytes a slot (plus one word in 32 of padding) fit
# the 227 KB of shared memory a block may use (a power of two, as the
# network needs)
MAX_WIDTH = 16384
MAX_ELEMS = 32  # slots a thread holds in registers
WARP_BLOCK = 128  # threads of a block of warp-sorted rows


class Geometry(NamedTuple):
    rows_per_block: int
    threads_per_row: int
    elems: int  # slots a thread holds
    shared_bytes: int


def launch_geometry(c: int) -> Geometry:
    """The kernel's launch for rows of width ``c`` (a power of two no
    wider than :data:`MAX_WIDTH`): ``min(c, 32)`` slots a thread and
    ``max(1, c / 32)`` threads a row.  A row of at most 32 threads is
    sorted inside one warp, several rows to a block of
    :data:`WARP_BLOCK` threads; a wider row takes a block of its own.
    Shared memory holds the block's slots in three u32 planes with one
    spare word in 32."""
    if c < 1 or c & (c - 1) or c > MAX_WIDTH:
        raise ValueError(
            f"row width {c} must be a power of two <= {MAX_WIDTH} "
            "(one row must fit a block's shared memory)"
        )
    e = min(c, MAX_ELEMS)
    t = c // e
    rows = WARP_BLOCK // t if t <= 32 else 1
    threads = rows * t
    return Geometry(rows, t, e, threads // 32 * 3 * 33 * e * 4)


def stage_split(c: int) -> dict[str, int]:
    """How many of the log2(c)(log2(c)+1)/2 stages of a row run in
    registers, by warp shuffles and through shared memory, and the
    shared-memory round trips of a row (those stages plus the two
    layout passes)."""
    e = launch_geometry(c).elems
    split = {"registers": 0, "shuffles": 0, "shared": 0}
    k = 2
    while k <= c:
        j = k // 2
        while j >= 1:
            if j < e:
                split["registers"] += 1
            elif j < 32 * e:
                split["shuffles"] += 1
            else:
                split["shared"] += 1
            j //= 2
        k *= 2
    split["shared_round_trips"] = split["shared"] + 2
    return split


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
    geo = launch_geometry(c)
    hi_o, lo_o, val_o = (torch.empty_like(t) for t in (hi, lo, val))
    lib = build.library()
    with torch.cuda.device(hi.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.repro_sort_rows(
            hi.data_ptr(), lo.data_ptr(), val.data_ptr(),
            hi_o.data_ptr(), lo_o.data_ptr(), val_o.data_ptr(),
            r, c, *geo, stream,
        )
    build.check(code, "bitonic kernel")
    return hi_o, lo_o, val_o
