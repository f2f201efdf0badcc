"""Mesh-scale sort: the paper's partition-and-concatenate over the ranks
of a data mesh (port of ``src/repro/core/distributed.py``; DESIGN.md
§2).

Mapping onto the paper, as in the reference:

  reader thread T_i            -> rank i (one shard of the input)
  f partitions                 -> one partition per rank (equi-depth by
                                  the learned CDF => balanced all-to-all)
  thread-local fragments       -> per-destination capacity-padded send rows
  flush fragments to files     -> ONE all-to-all collective
  sorter thread per partition  -> rank-local LearnedSort
  concatenate partitions       -> rank i holds the i-th contiguous key
                                  range => the global array is sorted

The reference runs one ``shard_map`` program over a jax mesh; here every
rank calls the returned function on its own shard
(``launch/mesh.DataMesh``), and each tiled ``lax.all_to_all`` is one
``all_to_all_single`` with equal splits.  The splits stay
capacity-padded exactly as the reference pads them, so ``lost`` equals
the reference's.  ``hi``, ``lo`` and ``val`` cross the wire together,
stacked as int64 (the words zero-extended: hazard a), in one exchange
where the reference makes three; an empty slot's payload is
:data:`EMPTY`, so padding is known by its slot and not by its key.  Buckets come from the RMI kernel
(``ops.rmi_bucket``), bit-equal to the eager ``predict_bucket``; the
reference's router is jitted, so its ids may differ at an exact bucket
boundary (hazard b).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core import learned_sort, partition, rmi
from repro_torch.core.encoding import SENTINEL
from repro_torch.kernels import ops


# An empty send slot's payload: outside int32, so a real payload (any
# int32, -1 included) never reads as empty.
EMPTY = -(1 << 32)


def exchange_rows(mesh, *cols: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """One tiled all-to-all of several ``(n_dev, k)`` columns: row ``j``
    of every column goes to rank ``j``.  The columns travel stacked as
    int64 in one exchange and come back in their own dtypes."""
    n_dev, k = cols[0].shape
    send = torch.stack([c.to(torch.int64) for c in cols], dim=1)
    recv = mesh.all_to_all(send)  # (n_dev, len(cols), k)
    return tuple(recv[:, i].to(c.dtype) for i, c in enumerate(cols))


def transpose_shuffle(mesh, n_dev: int, *cols: torch.Tensor):
    """The reference's decorrelation round: block ``j`` of each local
    column goes to rank ``j``, so every rank holds a position-stratified
    sample of the whole input (DESIGN.md §2)."""
    blocks = exchange_rows(mesh, *(c.reshape(n_dev, -1) for c in cols))
    return tuple(b.reshape(-1) for b in blocks)


def route(mesh, model: rmi.RMIParams, hi, lo, capacity: int, discard=None):
    """The router's send slots: each row's destination rank from the RMI
    kernel, packed ``capacity`` slots a destination (partition.
    bucket_matrix).  Rows where ``discard`` holds go to an extra bucket
    that is never sent, so they take no capacity.  Returns ``(g, valid,
    lost)``: the ``(n_dev, capacity)`` row index of each slot (int64),
    whether the slot holds a row, and the rows that did not fit (shape
    ``(1,)``, int32)."""
    n_dev = mesh.world_size
    bucket = ops.rmi_bucket(model, hi, lo, n_dev)
    if discard is not None:
        bucket = torch.where(discard, n_dev, bucket)
    gather_idx, valid, counts = partition.bucket_matrix(
        bucket, n_dev + (discard is not None), capacity
    )
    lost = torch.clamp(counts[:n_dev] - capacity, min=0).sum()
    return (gather_idx[:n_dev].to(torch.int64), valid[:n_dev],
            lost.to(torch.int32)[None])


def make_sort_fn(
    mesh,
    axis_names: Sequence[str],
    model: rmi.RMIParams,
    n_per_device: int,
    *,
    capacity_factor: float = 1.5,
    pre_shuffle: bool = True,
):
    """Build the global sort over ``mesh``'s ranks (``axis_names`` must
    name its axis, as in the reference's signature).

    Returns ``fn(hi, lo, val) -> (hi_s, lo_s, val_s, n_valid, lost)``
    over this rank's shard: ``hi``/``lo`` int64-carried u32 words and
    ``val`` int32 payloads, ``n_per_device`` of each.  The outputs are
    this rank's sorted segment of the rank's ascending key range, padded
    with SENTINEL keys (``val = -1``) to ``capacity * n_dev``, its valid
    count and the records it could not send (shape ``(1,)`` each).
    Concatenating the valid prefixes of every rank in rank order is the
    fully sorted sequence (:func:`global_sorted_from_shards`) — the
    paper's "no merge".  A real key whose words are SENTINEL's stays in
    the valid prefix, ahead of the padding (the reference counts it as
    padding and drops it).  The RMI kernel buckets the keys, and
    ``learned_sort.sort_device`` sorts what arrives; every rank must call
    ``fn`` the same number of times.
    """
    mesh.check_axes(axis_names)
    n_dev = mesh.world_size
    capacity = partition.route_capacity(n_per_device, n_dev, capacity_factor)
    out_width = capacity * n_dev
    model = model.to(mesh.device)

    def fn(hi, lo, val):
        if hi.shape[0] != n_per_device:
            raise ValueError(
                f"shard has {hi.shape[0]} records, built for {n_per_device}"
            )
        hi, lo, val = (t.to(mesh.device) for t in (hi, lo, val))
        if pre_shuffle:
            hi, lo, val = transpose_shuffle(mesh, n_dev, hi, lo, val)

        # ---- partition: predict the destination rank (equi-depth bucket)
        g, valid, lost = route(mesh, model, hi, lo, capacity)
        send_hi = torch.where(valid, hi[g], SENTINEL)
        send_lo = torch.where(valid, lo[g], SENTINEL)
        send_val = torch.where(valid, val[g].to(torch.int64), EMPTY)

        # ---- shuffle: one all-to-all replaces all fragment-file I/O
        recv_hi, recv_lo, recv_val = (
            t.reshape(out_width)
            for t in exchange_rows(mesh, send_hi, send_lo, send_val)
        )
        real = recv_val != EMPTY

        # ---- local sort (LearnedSort; sentinels sort last), then the
        # padding moves behind real keys that share its SENTINEL words
        hi_s, lo_s, perm = learned_sort.sort_device(model, recv_hi, recv_lo)
        perm = perm.to(torch.int64)
        pad_last = torch.sort((~real[perm]).to(torch.int8), stable=True).indices
        perm = perm[pad_last]
        val_s = torch.where(real[perm], recv_val[perm], -1).to(torch.int32)
        n_valid = real.sum().to(torch.int32)
        return hi_s[pad_last], lo_s[pad_last], val_s, n_valid[None], lost

    return fn


def _host(x) -> np.ndarray:
    if isinstance(x, (list, tuple)):
        return np.stack([_host(t) for t in x])
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def global_sorted_from_shards(hi_s, lo_s, val_s, n_valid, n_dev: int):
    """Host-side compaction: drop the sentinel padding, concatenate the
    shards in rank order.  Each argument holds every rank's output —
    gathered with ``DataMesh.all_gather``, or a list of the ranks'
    tensors or arrays."""
    hi_s = _host(hi_s).reshape(n_dev, -1)
    lo_s = _host(lo_s).reshape(n_dev, -1)
    val_s = _host(val_s).reshape(n_dev, -1)
    n_valid = _host(n_valid).reshape(n_dev)
    his, los, vals = [], [], []
    for d in range(n_dev):
        k = int(n_valid[d])
        his.append(hi_s[d, :k])
        los.append(lo_s[d, :k])
        vals.append(val_s[d, :k])
    return (
        np.concatenate(his),
        np.concatenate(los),
        np.concatenate(vals),
    )
