"""Pluggable sort executors: the seam between the sorter stage and the
sort implementation (port of ``src/repro/core/executor.py``; DESIGN.md
§10).

An executor consumes a stream of ``(tag, RecordBlock)`` items and yields
``(tag, sorted RecordBlock)``.  Two implementations are ported:

* :class:`HostSortExecutor` — the host LearnedSort (``sort_host``), one
  NumPy pass per partition, zero device dispatches.  Its output defines
  byte-identity.
* :class:`BatchedDeviceExecutor` — packs partitions into fixed-shape
  super-batches with segment ids and sorts each with one call of the
  fused graph (``kernels/fused.py``): on a CUDA device the grid graph
  through the encode, RMI and bitonic kernels.  Dispatches are
  double-buffered (:data:`PIPELINE_DEPTH` in flight): while the card
  sorts batch *k*, the host packs batch *k+1* into a pinned staging
  buffer and uploads it with a non-blocking copy, and batch *k−1*'s
  permutation comes back by a non-blocking copy into pinned memory.
  A CUDA event recorded after each upload gates the reuse of that
  batch's staging buffer, so the host never overwrites bytes a copy
  has not yet read.

``PerPartitionDeviceExecutor`` and ``MeshBatchedExecutor`` are not
ported yet.  Every executor produces output byte-identical to the host
path: the stable memcmp order of the full key window, with the
touch-up beyond byte 8 applied in the executor's epilogue.
"""

from __future__ import annotations

import contextlib
from collections import deque

import numpy as np
import torch

from repro_torch.core import learned_sort, rmi
from repro_torch.core.encoding import ENCODED_BYTES
from repro_torch.core.format import RecordBlock
from repro_torch.kernels import fused

# Partitions per super-batch: one dispatch covers up to this many segments.
MAX_SEGMENTS = 32
# In-flight super-batches (pack k+1 / compute k / fetch k-1).
PIPELINE_DEPTH = 2


class SortExecutor:
    """Base class: stream protocol + shared instrumentation."""

    name = "base"
    # True when several sorter workers may drive sort_iter concurrently
    # (stateless executors); batching executors need a single caller.
    parallel_safe = True

    def __init__(self, model: rmi.RMIParams, clock=None):
        self.model = model
        self.clock = clock
        self.dispatches = 0
        self.fallbacks = 0
        self.batch_records = 0
        self.batch_slots = 0
        self.compile_keys: set = set()

    @property
    def jit_compiles(self) -> int:
        """Distinct static shapes dispatched (the reference's count of
        compiled graphs; PyTorch runs eagerly and compiles none)."""
        return len(self.compile_keys)

    @property
    def occupancy(self) -> float:
        """Mean fraction of super-batch slots holding real records."""
        return self.batch_records / self.batch_slots if self.batch_slots else 0.0

    def sort_iter(self, items):
        """``(tag, RecordBlock)`` stream in -> sorted stream out."""
        raise NotImplementedError

    def _timer(self, phase: str = "sort"):
        if self.clock is None:
            return contextlib.nullcontext()
        return self.clock.timer(phase)

    def _count_dispatch(self, slots: int, records: int, key) -> None:
        self.dispatches += 1
        self.batch_slots += slots
        self.batch_records += records
        new = key not in self.compile_keys
        self.compile_keys.add(key)
        if self.clock is not None:
            self.clock.add_counter("device_dispatches")
            self.clock.add_counter("batch_slots", slots)
            self.clock.add_counter("batch_records", records)
            if new:
                self.clock.add_counter("jit_compiles")


def _memcmp_touchup(keys: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """Epilogue: fix order beyond the 8-byte embedding (paper's strncmp
    step, §4) over the full key window, stably."""
    k = keys[perm]
    kv = np.ascontiguousarray(k).view(
        [("k", f"S{k.shape[1]}")]
    )["k"].reshape(-1)
    if (kv[:-1] > kv[1:]).any():
        perm = perm[np.argsort(kv, kind="stable")]
    return perm


def sort_partition(model: rmi.RMIParams, block: RecordBlock) -> RecordBlock:
    """Sort one partition's records with the host LearnedSort (the
    reference's host branch; its per-partition device chain is not
    ported yet).  Empty and single-record partitions short-circuit.
    Only the key-prefix matrix is sorted; the permutation then gathers
    the record bodies in one ``take``."""
    if block.n_records <= 1:
        return block
    perm = learned_sort.sort_host(model, np.ascontiguousarray(block.keys))
    return block.take(perm)


class HostSortExecutor(SortExecutor):
    """Host (NumPy) LearnedSort per partition — the reference path."""

    name = "host"
    parallel_safe = True

    def sort_iter(self, items):
        for tag, block in items:
            with self._timer():
                block = sort_partition(self.model, block)
            yield tag, block


class _Slot:
    """Host staging of one in-flight batch.

    The batch is packed into one byte buffer (keys, segment ids, row
    plan) and uploaded with a single copy; its permutation and overflow
    flag come back into host buffers.  On a CUDA device the buffers are
    pinned, both copies are non-blocking, and two events order them:
    ``uploaded`` gates the reuse of the staging buffer, ``fetched``
    says the results have landed.  On the CPU the device tensors are
    views of the staging buffer and everything runs in order.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.host = torch.empty(0, dtype=torch.uint8)
        self.perm = torch.empty(0, dtype=torch.int32)
        self.flag = torch.zeros((), dtype=torch.bool)
        if self.cuda:
            self.flag = self.flag.pin_memory()
        self.uploaded: "torch.cuda.Event | None" = None
        self.fetched: "torch.cuda.Event | None" = None

    def stage(self, nbytes: int) -> np.ndarray:
        """The staging buffer as NumPy bytes, once its last upload is done."""
        if self.uploaded is not None:
            self.uploaded.synchronize()
        if self.host.numel() < nbytes:
            self.host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=self.cuda)
        return self.host.numpy()[:nbytes]

    def upload(self, nbytes: int) -> torch.Tensor:
        if not self.cuda:
            return self.host[:nbytes]
        dev = self.host[:nbytes].to(self.device, non_blocking=True)
        self.uploaded = torch.cuda.Event()
        self.uploaded.record()
        return dev

    def fetch(self, perm: torch.Tensor, overflow: "torch.Tensor | None") -> None:
        if not self.cuda:
            self.perm = perm
            self.flag = overflow if overflow is not None else torch.zeros((), dtype=torch.bool)
            return
        n = perm.shape[0]
        if self.perm.numel() < n:
            self.perm = torch.empty(n, dtype=torch.int32, pin_memory=True)
        self.perm[:n].copy_(perm, non_blocking=True)
        if overflow is None:
            self.flag.zero_()
        else:
            self.flag.copy_(overflow, non_blocking=True)
        self.fetched = torch.cuda.Event()
        self.fetched.record()

    def result(self, n: int) -> tuple[np.ndarray, bool]:
        """The fetched permutation (a view: copy before the slot's next
        batch) and the overflow flag; waits for the fetch on CUDA."""
        if self.fetched is not None:
            self.fetched.synchronize()
        return self.perm[:n].numpy(), bool(self.flag)


class BatchedDeviceExecutor(SortExecutor):
    """Batched executor: super-batch packing + one fused sort per batch,
    double-buffered across ``PIPELINE_DEPTH`` in-flight dispatches
    (DESIGN.md §10, §12).

    Two dispatch shapes behind the same packing/epilogue protocol:

    * **grid** (CUDA devices, or ``use_kernels`` on the CPU): encode
      kernel → fused RMI kernel → per-segment remap → row-wise bitonic
      kernel (``kernels/fused.grid_fast_path``); on CPU tensors the
      kernels' plain versions run.  Overflow → the stable fallback,
      counted in ``fallbacks``.
    * **flat** (the CPU default without ``use_kernels``): one stable
      ``(seg, hi, lo)`` sort.

    Both pack into size-bucketed static shapes (``fused.pad_target``).
    On a CUDA device the grid always runs the kernels.  ``device``
    defaults to the card and raises where there is none."""

    name = "batched"
    parallel_safe = False  # one packer must own the super-batch

    def __init__(
        self,
        model,
        *,
        device="cuda",
        use_kernels: bool = False,
        batch_slots: int = 1 << 20,
        batch_bytes: int = 256 << 20,
        max_segments: int = MAX_SEGMENTS,
        depth: int = PIPELINE_DEPTH,
        flat: "bool | None" = None,
        clock=None,
    ):
        super().__init__(model, clock=clock)
        self.device = resolve_device(device)
        on_cpu = self.device.type == "cpu"
        # note: self.batch_slots (base class) is the instrumentation
        # counter; the packing bound lives in _slots_cap/_bytes_cap
        self._slots_cap = max(2, batch_slots)
        self._bytes_cap = max(1, batch_bytes)
        self.max_segments = max(1, min(max_segments, MAX_SEGMENTS))
        self.depth = max(1, depth)
        self.flat = (on_cpu and not use_kernels) if flat is None else flat
        if not self.flat:
            # one-time upload of the leaf tables; dispatches reuse them
            self.model = model.to(self.device)
        self._slots = [_Slot(self.device) for _ in range(self.depth)]
        self._next_slot = 0

    # -- packing -------------------------------------------------------

    def _dispatch(self, entries: list) -> tuple:
        """Pack ``entries`` into one batch and launch the fused graph
        (asynchronously on a CUDA device)."""
        slot = self._slots[self._next_slot]
        self._next_slot = (self._next_slot + 1) % self.depth
        sizes = [b.n_records for _, b in entries]
        total = sum(sizes)
        n_pad = fused.pad_target(total)
        s_max = self.max_segments
        # staging layout: keys (n_pad, 8) u8 | seg (n_pad,) i32 |
        # row_base (s_max,) i32 | rows_per_seg (s_max,) i32
        n_key = n_pad * ENCODED_BYTES
        n_seg = n_key + 4 * n_pad
        nbytes = n_seg + 8 * s_max
        buf = slot.stage(nbytes)
        keys = buf[:n_key].reshape(n_pad, ENCODED_BYTES)
        seg = buf[n_key:n_seg].view(np.int32)
        plan = buf[n_seg:].view(np.int32)
        keys[:] = 0
        plan[:] = 0
        off = 0
        for s, (_, b) in enumerate(entries):
            m = b.n_records
            w = min(b.keys.shape[1], ENCODED_BYTES)
            keys[off : off + m, :w] = b.keys[:, :w]
            seg[off : off + m] = s
            off += m
        k = len(entries)
        if self.flat:
            # padding sorts strictly after every real segment (seg = k)
            # and is dropped by the perm < total filter
            if n_pad != total:
                keys[total:] = 0xFF
                seg[total:] = k
            self._count_dispatch(n_pad, total, ("flat", n_pad))
            dev = slot.upload(nbytes)
            keys_d = dev[:n_key].view(n_pad, ENCODED_BYTES)
            seg_d = dev[n_key:n_seg].view(torch.int32)
            slot.fetch(fused.flat_segmented_sort(keys_d, seg_d), None)
            return entries, sizes, total, n_pad, slot, None
        pad = n_pad - total
        pad_share = np.zeros(k, dtype=np.int64)
        if pad:
            # padding spreads across the segments proportionally, each
            # share recycling its own segment's keys, so it stays inside
            # the segment's CDF band (see the reference for why)
            np_sizes = np.asarray(sizes, dtype=np.int64)
            pad_share = pad * np_sizes // total
            rem = np.argsort(
                pad * np_sizes % total, kind="stable"
            )[::-1][: pad - int(pad_share.sum())]
            pad_share[rem] += 1
            starts = np.concatenate([[0], np.cumsum(np_sizes)[:-1]])
            p = total
            for s in range(k):
                m = int(pad_share[s])
                if not m:
                    continue
                keys[p : p + m] = keys[
                    starts[s] + (np.arange(m) % np_sizes[s])
                ]
                seg[p : p + m] = s
                p += m
        n_rows, capacity = fused.plan_batch(n_pad, s_max)
        # proportional row allocation: every segment gets >= 1 private
        # row, the rest go out by size (padding included)
        alloc_sizes = np.asarray(sizes, dtype=np.int64) + pad_share
        alloc = np.ones(k, dtype=np.int64)
        alloc += (n_rows - k) * alloc_sizes // n_pad
        row_base, rows_per_seg = plan[:s_max], plan[s_max:]
        rows_per_seg[:k] = alloc
        row_base[:k] = np.concatenate([[0], np.cumsum(alloc)[:-1]])
        self._count_dispatch(n_pad, total, (n_pad, n_rows, capacity))
        dev = slot.upload(nbytes)
        keys_d = dev[:n_key].view(n_pad, ENCODED_BYTES)
        seg_d = dev[n_key:n_seg].view(torch.int32)
        plan_d = dev[n_seg:].view(torch.int32)
        perm_d, overflow_d, hi_d, lo_d = fused.grid_fast_path(
            self.model,
            keys_d,
            seg_d,
            plan_d[:s_max],
            plan_d[s_max:],
            n_rows=n_rows,
            capacity=capacity,
        )
        slot.fetch(perm_d, overflow_d)
        return entries, sizes, total, n_pad, slot, (seg_d, hi_d, lo_d)

    def _finish(self, handle: tuple):
        """Fetch one batch's permutation and emit its sorted blocks."""
        entries, sizes, total, n_pad, slot, words = handle
        perm, overflowed = slot.result(n_pad)  # waits for the device
        if overflowed:
            # the reference's lax.cond fallback: stable (seg, hi, lo)
            self.fallbacks += 1
            perm = fused.stable_segmented_perm(*words).cpu().numpy()
        perm = perm[perm < total]  # drop the padding records (a copy)
        bases = np.concatenate([[0], np.cumsum(sizes)])
        pos = 0
        for s, (tag, block) in enumerate(entries):
            m = sizes[s]
            local = perm[pos : pos + m] - bases[s]
            pos += m
            if local.size != m or (local < 0).any() or (local >= m).any():
                raise RuntimeError(
                    f"segmented sort mixed segments: segment {s} got "
                    f"indices outside [0, {m}) — executor invariant broken"
                )
            local = _memcmp_touchup(block.keys, local)
            yield tag, block.take(local)

    # -- stream protocol ----------------------------------------------

    def sort_iter(self, items):
        pending: deque = deque()
        cur: list = []
        cur_records = 0
        cur_bytes = 0
        for tag, block in items:
            if block.n_records <= 1:
                yield tag, block  # empty/single: never dispatched
                continue
            cur.append((tag, block))
            cur_records += block.n_records
            cur_bytes += block.n_bytes
            if (
                len(cur) >= self.max_segments
                or cur_records >= self._slots_cap
                or cur_bytes >= self._bytes_cap
            ):
                with self._timer():
                    pending.append(self._dispatch(cur))
                cur, cur_records, cur_bytes = [], 0, 0
                while len(pending) >= self.depth:
                    with self._timer():
                        yield from self._finish(pending.popleft())
        if cur:
            with self._timer():
                pending.append(self._dispatch(cur))
        while pending:
            with self._timer():
                yield from self._finish(pending.popleft())


def resolve_device(device) -> torch.device:
    """The device a run asked for; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but no CUDA device is "
            "available (pass device='cpu' to run on the host)"
        )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r} (cpu or cuda)")
    return dev


def make_executor(
    model: rmi.RMIParams,
    config=None,
    *,
    device_sort: bool = False,
    use_kernels: bool = False,
    executor: str = "auto",
    batch_slots: int = 0,
    batch_bytes: int = 0,
    max_segments: int = 0,
    device=None,
    clock=None,
) -> SortExecutor:
    """Build the executor for a sort run.

    ``config`` (``repro_torch.core.config.ExecutorConfig``) is the knob
    surface; non-default keywords override it.  Without a config or a
    ``device``, the run is on the card (``"cuda"``, which raises where
    there is none).  ``executor="auto"`` resolves by device: on a CUDA
    device, the batched executor on the grid graph with the kernels; on
    the CPU, as the reference does on its CPU backend (host unless
    ``device_sort``/``use_kernels``, then batched).  ``"host"`` and
    ``"batched"`` force an implementation.
    """
    if config is not None:
        device_sort = device_sort or config.device_sort
        use_kernels = use_kernels or config.use_kernels
        executor = executor if executor != "auto" else config.executor
        batch_slots = batch_slots or config.batch_slots
        batch_bytes = batch_bytes or config.batch_bytes
        max_segments = max_segments or config.max_segments
        device = device if device is not None else config.device
    dev = resolve_device(device if device is not None else "cuda")
    choice = executor or "auto"
    if choice == "auto":
        use_device = device_sort or use_kernels or dev.type == "cuda"
        choice = "batched" if use_device else "host"
    if choice == "host":
        return HostSortExecutor(model, clock=clock)
    if choice == "batched":
        kw: dict = {"clock": clock}
        if batch_slots:
            kw["batch_slots"] = batch_slots
        if batch_bytes:
            kw["batch_bytes"] = batch_bytes
        if max_segments:
            kw["max_segments"] = min(max_segments, MAX_SEGMENTS)
        return BatchedDeviceExecutor(
            model, device=dev, use_kernels=use_kernels, **kw
        )
    if choice in ("per_partition", "mesh"):
        raise NotImplementedError(f"executor {choice!r} is not ported yet")
    raise ValueError(
        f"unknown executor {executor!r} (expected auto|host|batched)"
    )
