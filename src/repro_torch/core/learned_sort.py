"""LearnedSort (paper §3.4) on the device, one array or a super-batch
of partitions, plus the host sort and the comparison oracle (port of
``src/repro/core/learned_sort.py`` and ``src/repro/kernels/fused.py``).

:func:`sort_device` sorts one array.  The benchmark times it, it is the
local sort of the distributed step (``distributed.make_sort_fn``), and
the per-partition executor runs it once a partition:

  1. the RMI kernel predicts an equi-depth minor-bucket id per key,
  2. the ids are counted (``partition.bucket_histogram``) and the
     counts tested against the row width; a bucket over it sends the
     call to the stable fallback, which sorts the words alone,
  3. otherwise a stable counting-sort permutation groups records by
     bucket (:func:`grid_rows`, from the counts of step 2 -> an
     ``(n_buckets, capacity)`` grid, SENTINEL-padded),
  4. the row-sort kernel sorts each row by ``(hi, lo, val)`` — the
     paper's touch-up and base-case sort in one,
  5. the rows are compacted back into one array.

Monotone model + per-bucket sort => globally sorted, with no merge.

Given the keys' tail words too (``encoding.encode_tail``: key bytes 8-11),
:func:`sort_device` orders by the whole key, as valsort checks gensort's
10 bytes: either path's 8-byte answer is stable, so each run of equal
``(hi, lo)`` holds its records in input order, and :func:`order_ties`
then sorts every record by ``(run, tail)``, one stable sort, in which a
record moves only inside its run.

Each call runs inside a ``repro_torch.sort_device`` profiler span, and
each step inside one of its own (``core.stages.stats.span``):
``rmi_bucket`` and ``sort_rows`` (in ``kernels/ops``), ``overflow_test``
(the count, the compare and the host sync), then ``grid`` and
``compact`` on a row-sorted call or ``fallback`` on one that overflowed,
and last ``full_key`` on a call given tail words.
Plain ``int`` counters on :func:`sort_device` count its ``calls`` and
``records``, of those the ``fallback_calls`` and ``fallback_records``
that the stable fallback sorted, and the ``full_key_calls`` and
``full_key_records`` given tail words; :func:`reset_counters` sets them
to 0, and so does ``ops.reset_launches``.

The **super-batch** graph is ``sort_file``'s device path: the batched
executor packs partitions into one padded batch with segment ids and
sorts it in one call (DESIGN.md §10, §12).  Two shapes:

* the **grid** (:func:`grid_fast_path`): encode kernel → RMI kernel at
  ``Q_RES`` → re-centring of the CDF position onto the segment's own
  rows → the same grid fill, row sort and compaction as
  :func:`sort_device` → a permutation.  Eager PyTorch has no in-graph
  branch (the reference's ``lax.cond``) without waiting on the device,
  so the fast path always runs and returns the overflow flag as a
  device tensor; the caller reads it with the permutation and takes
  :func:`stable_segmented_perm` only when it is set
  (:func:`fused_segmented_sort` does so at once).  The result is the
  reference's on every input.  The remap runs in float32 and is safe
  by monotonicity, as the reference's docstring explains (a segment's
  band is at most ``Q_RES = 2**20`` wide).
* the **flat** (:func:`flat_segmented_sort`): encode + one stable
  ``(seg, hi, lo)`` sort.

Kernels run on CUDA tensors and their plain versions on CPU tensors
(the reference's ``use_kernels`` switch is the tensor's device here).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import encoding, partition, rmi
from repro_torch.core.encoding import SENTINEL
from repro_torch.core.stages.stats import span
from repro_torch.kernels import ops

# Super-batch grid: target mean records per row (~4x headroom in
# ``capacity``), the row-count cap that bounds the grid, and the CDF
# quantization resolution (static, shape-independent).
ROW_TARGET = 256
MAX_ROWS = 1 << 14
Q_RES = 1 << 20


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1)).bit_length()


def _flat_index(counts: torch.Tensor, n: int, c: int) -> torch.Tensor:
    """(n,) int64 slots of a ``c``-wide grid that hold each row's first
    ``counts`` entries, row after row: the compaction's gather index."""
    ends = torch.cumsum(counts.to(torch.int64), 0)
    starts = ends - counts
    pos = torch.arange(n, dtype=torch.int64, device=counts.device)
    row = torch.searchsorted(ends, pos, right=True)
    return row * c + pos - starts[row]


def _compact(
    hi_m: torch.Tensor,
    lo_m: torch.Tensor,
    val_m: torch.Tensor,
    counts: torch.Tensor,
    n: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(f, c) sorted rows + per-row valid counts -> (n,) concatenated."""
    flat = _flat_index(counts, n, hi_m.shape[1])
    return (
        hi_m.reshape(-1)[flat],
        lo_m.reshape(-1)[flat],
        val_m.reshape(-1)[flat],
    )


def _key_sort(hi: torch.Tensor, lo: torch.Tensor):
    """Stable ``(hi, lo)``-ascending sort of the packed words:
    ``(values, indices)``, the sorted :func:`encoding.packed_key` and the
    int64 permutation."""
    return torch.sort(encoding.packed_key(hi, lo), stable=True)


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
    hi: torch.Tensor,
    lo: torch.Tensor,
    bucket: torch.Tensor,
    counts: torch.Tensor,
    capacity: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The ``(n_buckets, capacity)`` grid ``(hi_m, lo_m, val_m)`` of the
    records by their bucket ids and the ids' ``counts``
    (``partition.bucket_histogram``'s), for both graphs.  Empty slots hold
    SENTINEL words and ``val = n``, so that real records (``val < n``)
    win the ``val`` tiebreak against padding even when their own words
    are SENTINEL (callers pad inputs with it)."""
    n = hi.shape[0]
    gather_idx, valid = partition.bucket_grid(bucket, counts, capacity)
    gather = gather_idx.to(torch.int64)
    hi_m = torch.where(valid, hi[gather], SENTINEL)
    lo_m = torch.where(valid, lo[gather], SENTINEL)
    val_m = torch.where(valid, gather_idx, n)
    return hi_m, lo_m, val_m


def sort_device(
    model: rmi.RMIParams,
    hi: torch.Tensor,
    lo: torch.Tensor,
    tail: "torch.Tensor | None" = None,
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
    (``lax.cond``); here the RMI's bucket ids are counted and the counts
    read on the host before any grid is built, one wait on the device
    per call, and the grid is built and its rows sorted only when no
    bucket overflowed.  Under overflow (a bucket over
    ``capacity``, e.g. a duplicate flood, or the SENTINEL padding of a
    partition that is not a power of two, which all lands in the last
    bucket) the answer is the stable ``(hi, lo)`` sort of the whole
    input, and no grid is built.  Either way the result is the
    reference's, bit for bit: its ``lax.cond`` tests the same counts.

    With ``tail`` (the keys' tail words, ``encoding.encode_tail``) the
    answer is the stable sort by ``(hi, lo, tail)``, the whole key of up
    to 12 bytes, and the result carries the sorted tail words after
    ``lo``: ``(hi_sorted, lo_sorted, tail_sorted, perm)``.  Without it
    the call runs none of the tail's work.
    """
    n = hi.shape[0]
    sort_device.calls += 1
    sort_device.records += n
    if tail is not None:
        sort_device.full_key_calls += 1
        sort_device.full_key_records += n
    with span("repro_torch.sort_device"):
        n_buckets, capacity = grid_shape(n, n_buckets, capacity_factor)
        bucket = ops.rmi_bucket(model, hi, lo, n_buckets)
        with span("repro_torch.overflow_test"):
            counts = partition.bucket_histogram(bucket, n_buckets)
            overflow = bool((counts > capacity).any())
        # the ids are freed once read, before either path's sort
        if overflow:
            del bucket
            sort_device.fallback_calls += 1
            sort_device.fallback_records += n
            # full comparison sort — correct under any skew/duplicates
            with span("repro_torch.fallback"):
                out = sort_oracle(hi, lo)
        else:
            with span("repro_torch.grid"):
                grid = grid_rows(hi, lo, bucket, counts, capacity)
            del bucket
            rows = ops.sort_rows(*grid)
            with span("repro_torch.compact"):
                out = _compact(*rows, counts, n)
        if tail is not None:
            with span("repro_torch.full_key"):
                out = order_ties(*out, tail)
    return (*out, overflow) if return_overflow else out


def order_ties(
    hi_s: torch.Tensor,
    lo_s: torch.Tensor,
    perm: torch.Tensor,
    tail: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """A stable ``(hi, lo)`` answer ``(hi_s, lo_s, perm)`` and the input's
    tail words -> the stable ``(hi, lo, tail)`` answer ``(hi_s, lo_s,
    tail_s, perm)``.  Each run of equal ``(hi_s, lo_s)`` is numbered (a
    scan of its starts), and one stable sort of ``run << 32 | tail``
    orders every record inside its run by tail, ties in the input order
    the run already holds.  No record leaves its run, so ``hi_s`` and
    ``lo_s`` stand, and the tails are the sort's own keys, unpacked."""
    n = hi_s.shape[0]
    starts = torch.ones(n, dtype=torch.bool, device=hi_s.device)
    torch.ne(hi_s[1:], hi_s[:-1], out=starts[1:])
    starts[1:] |= lo_s[1:] != lo_s[:-1]
    key = torch.cumsum(starts, 0)
    del starts
    key <<= 32
    key |= tail.index_select(0, perm)
    key, order = torch.sort(key, stable=True)
    return hi_s, lo_s, key.bitwise_and_(0xFFFFFFFF), perm[order]


def reset_counters() -> None:
    """Set :func:`sort_device`'s counters to 0."""
    sort_device.calls = sort_device.records = 0
    sort_device.fallback_calls = sort_device.fallback_records = 0
    sort_device.full_key_calls = sort_device.full_key_records = 0


def sort_oracle(
    hi: torch.Tensor, lo: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reference comparison sort: stable by (hi, lo); returns the sorted
    words and the int32 permutation.  The words are unpacked from the
    sort's own sorted keys, a stream, not gathered through the
    permutation."""
    keys, perm = _key_sort(hi, lo)
    return *encoding.unpack_key(keys), perm.to(torch.int32)


# ---------------------------------------------------------------------------
# Super-batch graph: many partitions, told apart by segment ids
# ---------------------------------------------------------------------------


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


def stable_segmented_perm(
    seg: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor
) -> torch.Tensor:
    """Stable ``(seg, hi, lo)``-ascending permutation, int32: two stable
    passes, least significant key first (the packed ``(hi, lo)`` word,
    then ``seg``), so ties keep input order."""
    by_key = _key_sort(hi, lo).indices
    by_seg = torch.sort(seg[by_key], stable=True).indices
    return by_key[by_seg].to(torch.int32)


def segmented_grid_rows(
    model: rmi.RMIParams,
    keys: torch.Tensor,  # (n_pad, 8) uint8 — ENCODED_BYTES key prefixes
    seg: torch.Tensor,  # (n_pad,) int32 segment ids
    row_base: torch.Tensor,  # (max_segments,) int32 first row per segment
    rows_per_seg: torch.Tensor,  # (max_segments,) int32 rows per segment
    *,
    n_rows: int,
    capacity: int,
):
    """The grid graph up to the row sort: encode and RMI kernels, the
    per-segment remap, the count and :func:`grid_rows`.  Returns ``(hi,
    lo, hi_m, lo_m, val_m, counts)``; ``val_m`` ascends along each row."""
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
    band = torch.clamp(qmax - qmin, min=0) + 1
    frac = (q - qmin[seg64]).to(torch.float32) / band[seg64].to(torch.float32)
    rps = rows_per_seg[seg64].to(torch.float32)
    row = row_base[seg64] + rmi.f32_to_i32(frac * rps)
    counts = partition.bucket_histogram(row, n_rows)
    return (hi, lo, *grid_rows(hi, lo, row, counts, capacity), counts)


def grid_fast_path(
    model: rmi.RMIParams,
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
    hi, lo, hi_m, lo_m, val_m, counts = segmented_grid_rows(
        model, keys, seg, row_base, rows_per_seg,
        n_rows=n_rows, capacity=capacity,
    )
    _, _, val_s = ops.sort_rows(hi_m, lo_m, val_m)
    # the flag is read later, so an overflowing count may point past
    # the grid: clamp, so the discarded gather still stays inside it
    flat = _flat_index(counts, keys.shape[0], capacity)
    perm = val_s.reshape(-1)[flat.clamp_(0, n_rows * capacity - 1)]
    return perm, (counts > capacity).any(), hi, lo


def fused_segmented_sort(
    model: rmi.RMIParams,
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
    """Flat stable segmented sort: encode + one stable ``(seg, hi, lo)``
    sort, the row index carried (the grid's fallback promoted to the
    primary dispatch)."""
    return stable_segmented_perm(seg, *ops.encode_keys(keys))


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


reset_counters()
ops.COUNTER_RESETS.append(reset_counters)
