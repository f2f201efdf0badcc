"""Histogram kernel: per-bucket counts of ``(N,)`` int32 bucket ids.

Replaces ``src/repro/kernels/histogram.py:histogram_pallas``.  The CUDA
source is ``csrc/histogram.cu``; its note says what bounds the kernel
(its atomics, more than the 4 bytes read per id and 4 written per bin)
and its three strategies, which :func:`launch_geometry` chooses: a
private histogram a block, reduced over a thread-block cluster through
distributed shared memory, where the bins fit a block; the bins split
over a cluster of two blocks where they fit two; global atomics beyond.
:func:`histogram_plain` is the plain PyTorch version it is held
against, bit for bit.

Both count what the reference's wrapper and kernel count together: an
id outside ``[0, n_buckets)`` never counts (the reference pads with -1,
which its one-hot compare never matches).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build

SOURCE = "src/repro_torch/csrc/histogram.cu"
CLUSTER = 8  # blocks a cluster in the shared strategy
SPLIT_CLUSTER = 2  # in the split strategy
STRATEGIES = ("global", "shared", "split")  # csrc/histogram.cu's codes
# csrc/histogram.cu kPerLane<S>: a lane's ids a step; a warp's are 32 x that
IDS_PER_LANE = {"global": 4, "shared": 8, "split": 8}


class Geometry(NamedTuple):
    strategy: str  # one of STRATEGIES
    cluster: int  # blocks a cluster (0: no cluster)
    block_bins: int  # bins a block holds in its shared memory
    slice: int  # bins block r of a cluster owns: [r * slice, (r + 1) * slice)


def launch_geometry(n_buckets: int, max_bins: int) -> Geometry:
    """The kernel's strategy for ``n_buckets`` bins on a device whose
    block holds ``max_bins`` bins of shared memory (:func:`max_block_bins`).

    * ``shared`` where the bins fit one block: each block of a cluster of
      :data:`CLUSTER` counts into all ``n_buckets`` bins of its own, and
      block r sums and flushes slice r of the cluster's histograms;
    * ``split`` where they fit a cluster of :data:`SPLIT_CLUSTER` blocks:
      block r holds slice r alone, and every block adds into its owner
      (larger clusters, which would hold more bins, lose to global
      atomics: remote adds cost more than L2 atomics);
    * ``global`` beyond: global atomics."""
    if n_buckets < 1:
        raise ValueError(f"n_buckets {n_buckets} < 1")
    if n_buckets <= max_bins:
        return Geometry("shared", CLUSTER, n_buckets, -(-n_buckets // CLUSTER))
    if n_buckets <= SPLIT_CLUSTER * max_bins:
        part = -(-n_buckets // SPLIT_CLUSTER)
        return Geometry("split", SPLIT_CLUSTER, part, part)
    return Geometry("global", 0, 0, 0)


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


_max_bins: dict[int, int] = {}


def max_block_bins() -> int:
    """Bins the shared memory a block of the current device can opt into
    holds (4 bytes a bin; 58,112 on an H100).  Read once a device."""
    dev = torch.cuda.current_device()
    if dev not in _max_bins:
        bins = ctypes.c_int(0)
        build.check(
            build.library().repro_histogram_max_bins(ctypes.byref(bins)),
            "histogram kernel",
        )
        _max_bins[dev] = bins.value
    return _max_bins[dev]


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
        geo = launch_geometry(n_buckets, max_block_bins())
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.repro_histogram(
            ids.data_ptr(), ids.shape[0], int(n_buckets),
            STRATEGIES.index(geo.strategy), geo.cluster, geo.block_bins,
            geo.slice, out.data_ptr(), stream,
        )
    build.check(code, "histogram kernel")
    return out
