"""Equi-depth model-based partitioning (paper §3.3) + radix baseline, for
the PyTorch port (port of ``src/repro/core/partition.py``).

The dense ``(n_buckets, capacity)`` grid of :func:`bucket_grid` is the
device LearnedSort's routing layer (``learned_sort.grid_rows``), and
:func:`bucket_matrix`'s that of the distributed router and the MoE
dispatch.  These are tensor-level operations, not
kernels, apart from the counts (the histogram kernel through
``ops.bucket_histogram``): they use PyTorch's stable sort, scatters and
cumulative sums, and none of them waits on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import encoding, rmi
from repro_torch.kernels import ops


def route_capacity(
    n_per_device: int, n_dev: int, capacity_factor: float
) -> int:
    """Per-(source, destination) send-row capacity for the all-to-all
    routers: the next power of two >= ``n_per_device * capacity_factor /
    n_dev``, never less than 1 (exact powers of two are kept)."""
    need = max(1, int(n_per_device * capacity_factor / n_dev))
    return 1 << max(0, (need - 1).bit_length())


def bucket_histogram(bucket_ids: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Per-bucket counts of (N,) int32 ids, (n_buckets,) int32: the
    histogram kernel on a CUDA tensor, its plain version elsewhere
    (``ops.bucket_histogram``).  Unlike ``torch.bincount`` it never waits
    on the device for the length."""
    return ops.bucket_histogram(bucket_ids, n_buckets)


def take_by_bucket(bucket_ids: torch.Tensor) -> torch.Tensor:
    """Stable counting-sort permutation: records grouped by bucket, input
    order kept inside a bucket (the paper's append-to-fragment order)."""
    return torch.sort(bucket_ids, stable=True).indices


def _extents(
    bucket_ids: torch.Tensor, counts: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(perm, starts): grouped permutation + each bucket's first slot in
    it, from the ids and their ``counts``."""
    starts = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    return take_by_bucket(bucket_ids), starts


def bucket_offsets(
    bucket_ids: torch.Tensor, n_buckets: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(perm, starts, counts): grouped permutation + per-bucket extents."""
    counts = bucket_histogram(bucket_ids, n_buckets)
    return (*_extents(bucket_ids, counts), counts)


def bucket_matrix(
    bucket_ids: torch.Tensor, n_buckets: int, capacity: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gather indices arranging records into a ``(n_buckets, capacity)``
    grid: ``(gather_idx, valid, counts)``, :func:`bucket_histogram`'s
    counts and :func:`bucket_grid` built from them.

    ``gather_idx[b, c]`` indexes the source array (0 for invalid slots)
    and ``valid[b, c]`` marks real records.  Records beyond ``capacity``
    in an overflowing bucket land in one extra slot that is dropped, so
    they are NOT represented — callers check ``counts > capacity``."""
    counts = bucket_histogram(bucket_ids, n_buckets)
    return (*bucket_grid(bucket_ids, counts, capacity), counts)


def bucket_grid(
    bucket_ids: torch.Tensor, counts: torch.Tensor, capacity: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`bucket_matrix`'s ``(gather_idx, valid)`` from the bucket
    ids and their ``counts`` (:func:`bucket_histogram`'s), so a caller
    that has tested the counts need not count again."""
    n_buckets = counts.shape[0]
    perm, starts = _extents(bucket_ids, counts)
    dev = bucket_ids.device
    n = bucket_ids.shape[0]
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    sorted_buckets = bucket_ids.to(torch.int64)[perm]
    col = pos - starts.to(torch.int64)[sorted_buckets]  # rank within bucket
    flat_slot = torch.where(
        col < capacity,
        sorted_buckets * capacity + col,
        torch.full_like(col, n_buckets * capacity),
    )
    size = n_buckets * capacity + 1
    gather_idx = torch.zeros(size, dtype=torch.int32, device=dev)
    gather_idx.scatter_(0, flat_slot, perm.to(torch.int32))
    valid = torch.zeros(size, dtype=torch.bool, device=dev)
    valid.scatter_(0, flat_slot, torch.ones_like(flat_slot, dtype=torch.bool))
    return (
        gather_idx[:-1].reshape(n_buckets, capacity),
        valid[:-1].reshape(n_buckets, capacity),
    )


# ---------------------------------------------------------------------------
# Radix (equi-width) partitioner — the baseline the paper compares against
# ---------------------------------------------------------------------------


def radix_bucket(
    hi: torch.Tensor,
    lo: torch.Tensor,
    n_buckets: int,
    min_hi,
    min_lo,
    inv_range,
) -> torch.Tensor:
    """Equi-width bucket over the observed key range."""
    x = encoding.feature_f32(hi, lo, min_hi, min_lo, inv_range)
    return torch.clamp(rmi.f32_to_i32(x * n_buckets), max=n_buckets - 1)


def radix_bucket_np(hi: np.ndarray, lo: np.ndarray, n_buckets: int) -> np.ndarray:
    """Host-side equi-width partitioner over the full uint64 key domain."""
    x = hi.astype(np.float64) * 4294967296.0 + lo.astype(np.float64)
    x = x / 18446744073709551616.0
    return np.minimum((x * n_buckets).astype(np.int64), n_buckets - 1).astype(
        np.int32
    )


def model_bucket_np(
    params: rmi.RMIParams, hi: np.ndarray, lo: np.ndarray, n_buckets: int
) -> np.ndarray:
    return rmi.predict_bucket_np(params, hi, lo, n_buckets)


def partition_size_stats(counts: np.ndarray) -> dict[str, float]:
    """Mean/std statistics used for the paper's -23% variance claim (§3.3)."""
    counts = np.asarray(counts, dtype=np.float64)
    mean = counts.mean()
    return {
        "mean": float(mean),
        "std": float(counts.std()),
        "std_over_mean": float(counts.std() / mean) if mean > 0 else 0.0,
        "max_over_mean": float(counts.max() / mean) if mean > 0 else 0.0,
    }
