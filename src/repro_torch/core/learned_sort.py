"""LearnedSort (paper §3.4): the per-partition device chain, the host
sort and the comparison oracle (port of
``src/repro/core/learned_sort.py``).

:func:`sort_device` is the historical one-partition-at-a-time device
path (``executor="per_partition"``):

  1. the RMI kernel predicts an equi-depth minor-bucket id per key,
  2. a stable counting-sort permutation groups records by bucket
     (``partition.bucket_matrix`` -> an ``(n_buckets, capacity)`` grid,
     SENTINEL-padded),
  3. the row-sort kernel sorts each row by ``(hi, lo, val)`` — the
     paper's touch-up and base-case sort in one,
  4. the rows are compacted back into one array.

Monotone model + per-bucket sort => globally sorted, with no merge.
The batched executor's grid graph (``kernels/fused.py``) is the port's
main device path; this chain is the dispatch-count baseline.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import encoding, partition, rmi
from repro_torch.core.encoding import SENTINEL
from repro_torch.kernels import ops


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1)).bit_length()


def _compact(
    hi_m: torch.Tensor,
    lo_m: torch.Tensor,
    val_m: torch.Tensor,
    counts: torch.Tensor,
    n: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(f, c) sorted rows + per-row valid counts -> (n,) concatenated."""
    c = hi_m.shape[1]
    ends = torch.cumsum(counts.to(torch.int64), 0)
    starts = ends - counts
    pos = torch.arange(n, dtype=torch.int64, device=hi_m.device)
    row = torch.searchsorted(ends, pos, right=True)
    flat = row * c + pos - starts[row]
    return (
        hi_m.reshape(-1)[flat],
        lo_m.reshape(-1)[flat],
        val_m.reshape(-1)[flat],
    )


def grid_shape(
    n: int, n_buckets: int = 0, capacity_factor: float = 2.0
) -> tuple[int, int]:
    """``(n_buckets, capacity)`` of the chain's row grid for ``n`` keys —
    the reference's integers: ``next_pow2(n) / 512`` buckets by default
    (rows of ~256-1024 keys) and twice the mean fill, to a power of two,
    as the row width."""
    if n_buckets == 0:
        n_buckets = max(1, _next_pow2(n) // 512)
    return n_buckets, _next_pow2(int(n / n_buckets * capacity_factor) + 1)


def grid_rows(
    model: rmi.RMIParams,
    hi: torch.Tensor,
    lo: torch.Tensor,
    n_buckets: int,
    capacity: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Steps 1-2 of the chain: bucket ids by the RMI wrapper, then the
    ``(n_buckets, capacity)`` grid ``(hi_m, lo_m, val_m, counts)``.
    Empty slots hold SENTINEL words and ``val = n``, so that real
    records (``val < n``) win the ``val`` tiebreak against padding even
    when their own words are SENTINEL (callers pad inputs with it)."""
    n = hi.shape[0]
    bucket = ops.rmi_bucket(model, hi, lo, n_buckets)
    gather_idx, valid, counts = partition.bucket_matrix(
        bucket, n_buckets, capacity
    )
    gather = gather_idx.to(torch.int64)
    hi_m = torch.where(valid, hi[gather], SENTINEL)
    lo_m = torch.where(valid, lo[gather], SENTINEL)
    val_m = torch.where(valid, gather_idx, n)
    return hi_m, lo_m, val_m, counts


def sort_device(
    model: rmi.RMIParams,
    hi: torch.Tensor,
    lo: torch.Tensor,
    *,
    n_buckets: int = 0,
    capacity_factor: float = 2.0,
    return_overflow: bool = False,
) -> tuple[torch.Tensor, ...]:
    """Sort ``(hi, lo)`` ascending (int64-carried u32 words); returns
    ``(hi_sorted, lo_sorted, perm)``, ``perm`` int32 mapping output
    position -> input position, and with ``return_overflow`` whether
    the stable fallback ran.

    Runs where ``hi`` lies, through the kernel wrappers: the RMI and
    row-sort kernels on a CUDA tensor (``model`` must be on the same
    device), their plain versions on a CPU tensor.  The reference picks
    its fast path or its stable fallback inside the graph
    (``lax.cond``); here the row counts are read on the host once the
    RMI has bucketed the keys, one wait on the device per call, and
    the rows are sorted only when no bucket overflowed.  Under overflow
    (a bucket over ``capacity``, e.g. a duplicate flood, or the SENTINEL
    padding of a partition that is not a power of two, which all lands
    in the last bucket) the answer is the stable ``(hi, lo)`` sort of
    the whole input.  Either way the result is the reference's, bit
    for bit.
    """
    n = hi.shape[0]
    n_buckets, capacity = grid_shape(n, n_buckets, capacity_factor)
    hi_m, lo_m, val_m, counts = grid_rows(model, hi, lo, n_buckets, capacity)
    overflow = bool((counts > capacity).any())
    if overflow:
        # full comparison sort — correct under any skew/duplicates
        out = sort_oracle(hi, lo)
    else:
        out = _compact(*ops.sort_rows(hi_m, lo_m, val_m), counts, n)
    return (*out, overflow) if return_overflow else out


def sort_oracle(
    hi: torch.Tensor, lo: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reference comparison sort: stable by (hi, lo); returns the sorted
    words and the int32 permutation."""
    perm = torch.sort(encoding.packed_key(hi, lo), stable=True).indices
    return hi[perm], lo[perm], perm.to(torch.int32)


def sort_host(model: rmi.RMIParams, keys: np.ndarray) -> np.ndarray:
    """Host (NumPy) LearnedSort for the CPU file pipeline: returns
    ``perm`` sorting ``keys`` (N, K u8) in memcmp order (a copy of the
    reference's):

      1. the RMI predicts an equi-depth minor bucket per key,
      2. a stable integer sort groups by bucket (the counting-sort
         placement),
      3. one stable mergesort pass over the full keys of the now
         nearly-sorted array fixes model error and bytes beyond the
         8-byte embedding.
    """
    n = keys.shape[0]
    if n <= 1:
        return np.arange(n)
    hi, lo = encoding.encode_np(keys)
    n_buckets = max(64, 1 << max(0, (n // 256 - 1)).bit_length())
    b = rmi.predict_bucket_np(model, hi, lo, n_buckets)
    perm = np.argsort(b, kind="stable")
    k = np.ascontiguousarray(keys[perm]).view(
        [("k", f"S{keys.shape[1]}")]
    )["k"].reshape(-1)
    if (k[:-1] > k[1:]).any():
        perm = perm[np.argsort(k, kind="stable")]
    return perm
