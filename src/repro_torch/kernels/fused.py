"""Fused segmented sort graphs for the PyTorch port (port of
``src/repro/kernels/fused.py``; DESIGN.md §10, §12).

One call sorts a whole **super-batch** of partitions.  Two graph shapes
share the packing protocol:

* the **grid** graph: encode kernel → fused RMI kernel at ``Q_RES`` →
  per-segment re-centring of the CDF position onto the segment's own
  rows → scatter into an ``(n_rows, capacity)`` grid → row-wise bitonic
  kernel → compaction to a permutation.  This is the accelerator path;
  on CPU tensors the kernel wrappers run the plain versions instead
  (the reference's ``use_kernels`` switch is the tensor's device here).
* the **flat** graph: plain encode + one stable ``(seg, hi, lo)`` sort.

The reference chooses between the grid's fast path and its stable
fallback inside the graph (``lax.cond``).  Eager PyTorch has no such
branch without waiting on the device, so :func:`grid_fast_path` always
computes the fast path and returns the overflow flag as a device
tensor; the caller reads it together with the permutation and runs
:func:`stable_segmented_perm` only when it is set
(:func:`fused_segmented_sort` does exactly that, synchronously).  The
result is the reference's on every input.

The remap runs in float32 and is safe by monotonicity, as the
reference's docstring explains (``span <= Q_RES = 2**20``).
"""

from __future__ import annotations

import torch

from repro_torch.core import encoding, partition, rmi as rmi_lib
from repro_torch.core.encoding import SENTINEL
from repro_torch.kernels import ops

# Target mean records per touch-up row (~4x headroom in ``capacity``).
ROW_TARGET = 256
# Row-count cap: bounds the bitonic grid.
MAX_ROWS = 1 << 14
# CDF quantization resolution (static, shape-independent).
Q_RES = 1 << 20


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1)).bit_length()


def pad_target(n: int) -> int:
    """Size-bucketed static batch size: the next multiple of 1/16th of
    the enclosing power of two (min quantum 8) — at most 12.5% padding
    and O(log) distinct shapes."""
    p = _next_pow2(max(n, 8))
    q = max(p // 16, 8)
    return -(-n // q) * q


def plan_batch(n_pad: int, max_segments: int) -> tuple[int, int]:
    """Static grid shape ``(n_rows, capacity)`` for a padded batch; a
    pure function of ``n_pad``.  ``n_rows >= max_segments`` gives every
    segment at least one private row."""
    n_rows = _next_pow2(
        max(max_segments, min(n_pad // ROW_TARGET, MAX_ROWS))
    )
    capacity = _next_pow2(max(8, 4 * max(1, n_pad // n_rows)))
    return n_rows, capacity


def _compact_perm(
    val_m: torch.Tensor, counts: torch.Tensor, n: int
) -> torch.Tensor:
    """(n_rows, capacity) sorted rows + per-row counts -> (n,) perm.

    Under overflow (a count above ``capacity``) the result is discarded
    by the caller; the gather index is clamped so that it still stays
    inside the grid instead of faulting on the device."""
    n_rows, c = val_m.shape
    ends = torch.cumsum(counts, 0)
    starts = ends - counts
    pos = torch.arange(n, dtype=ends.dtype, device=val_m.device)
    row = torch.searchsorted(ends, pos, right=True)
    flat = (row * c + pos - starts[row]).clamp_(0, n_rows * c - 1)
    return val_m.reshape(-1)[flat]


def stable_segmented_perm(
    seg: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor
) -> torch.Tensor:
    """Stable ``(seg, hi, lo)``-ascending permutation, int32: two stable
    passes, least significant key first (the packed ``(hi, lo)`` word,
    then ``seg``), so ties keep input order."""
    by_key = torch.sort(encoding.packed_key(hi, lo), stable=True).indices
    by_seg = torch.sort(seg[by_key], stable=True).indices
    return by_key[by_seg].to(torch.int32)


def grid_rows(
    model: rmi_lib.RMIParams,
    keys: torch.Tensor,  # (n_pad, 8) uint8 — ENCODED_BYTES key prefixes
    seg: torch.Tensor,  # (n_pad,) int32 segment ids
    row_base: torch.Tensor,  # (max_segments,) int32 first row per segment
    rows_per_seg: torch.Tensor,  # (max_segments,) int32 rows per segment
    *,
    n_rows: int,
    capacity: int,
):
    """The grid graph up to the row sort: encode and RMI kernels, the
    per-segment remap and the scatter into rows.  Returns ``(hi, lo,
    hi_m, lo_m, val_m, counts)``; ``val_m`` ascends along each row."""
    n = keys.shape[0]
    s_max = row_base.shape[0]
    hi, lo = ops.encode_keys(keys)
    q = ops.rmi_bucket(model, hi, lo, Q_RES)
    # per-segment local frame: re-centre q on the band the segment's
    # keys actually occupy (a batch sees a slice of the key space)
    seg64 = seg.to(torch.int64)
    qmin = torch.full((s_max,), Q_RES, dtype=torch.int32, device=q.device)
    qmin = qmin.scatter_reduce(0, seg64, q, "amin")
    qmax = torch.zeros(s_max, dtype=torch.int32, device=q.device)
    qmax = qmax.scatter_reduce(0, seg64, q, "amax")
    span = torch.clamp(qmax - qmin, min=0) + 1
    frac = (q - qmin[seg64]).to(torch.float32) / span[seg64].to(torch.float32)
    rps = rows_per_seg[seg64].to(torch.float32)
    row = row_base[seg64] + rmi_lib.f32_to_i32(frac * rps)
    gather_idx, valid, counts = partition.bucket_matrix(row, n_rows, capacity)
    gather = gather_idx.to(torch.int64)
    hi_m = torch.where(valid, hi[gather], SENTINEL)
    lo_m = torch.where(valid, lo[gather], SENTINEL)
    # padding slots carry val = n so real records win every tiebreak
    val_m = torch.where(valid, gather_idx, n)
    return hi, lo, hi_m, lo_m, val_m, counts


def grid_fast_path(
    model: rmi_lib.RMIParams,
    keys: torch.Tensor,
    seg: torch.Tensor,
    row_base: torch.Tensor,
    rows_per_seg: torch.Tensor,
    *,
    n_rows: int,
    capacity: int,
):
    """The grid graph's fast path, with nothing read back: returns
    ``(perm, overflowed, hi, lo)`` as device tensors.  ``perm`` is the
    answer only when ``overflowed`` is false; otherwise the caller takes
    :func:`stable_segmented_perm` over ``(seg, hi, lo)``."""
    hi, lo, hi_m, lo_m, val_m, counts = grid_rows(
        model, keys, seg, row_base, rows_per_seg,
        n_rows=n_rows, capacity=capacity,
    )
    _, _, val_s = ops.sort_rows(hi_m, lo_m, val_m)
    perm = _compact_perm(val_s, counts, keys.shape[0])
    return perm, (counts > capacity).any(), hi, lo


def fused_segmented_sort(
    model: rmi_lib.RMIParams,
    keys: torch.Tensor,
    seg: torch.Tensor,
    row_base: torch.Tensor,
    rows_per_seg: torch.Tensor,
    *,
    n_rows: int,
    capacity: int,
) -> tuple[torch.Tensor, bool]:
    """``(perm, overflowed)``: the grid graph with its overflow fallback
    resolved (reads the flag, so it waits for the device)."""
    perm, overflow, hi, lo = grid_fast_path(
        model, keys, seg, row_base, rows_per_seg,
        n_rows=n_rows, capacity=capacity,
    )
    if bool(overflow):
        return stable_segmented_perm(seg, hi, lo), True
    return perm, False


def flat_segmented_sort(keys: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Flat stable segmented sort: plain encode + one stable ``(seg, hi,
    lo)`` sort, the row index carried (the grid's fallback promoted to
    the primary dispatch)."""
    hi, lo = encoding.encode(keys)
    return stable_segmented_perm(seg, hi, lo)
