"""The plain reference of the distributed sort's answer, and its check.

The configuration's guarantees (``guarantees`` in its file) define what
an answer over ``world`` ranks must be: each rank holds a segment, its
first ``n_valid`` rows valid; the segments concatenated in rank order
are ordered by the first 8 key bytes compared as unsigned bytes
(``order``); every input record, named by its payload ``val = r * n +
i`` (row ``i`` of rank ``r``'s input of ``n`` records), is there once
with its own words, and no record was lost in the exchange
(``complete``).  Equal keys may come in any order: stability is not a
guarantee of this deployment.

:func:`check` counts, in every rank at once, how far the ranks' answer
is from that, with nothing but the raw key bytes each rank made and the
default process group of ``torch.distributed``:

* ``lost_bad``: the records the program reports it could not send;
* ``order_bad``: neighbours out of order inside each rank's valid
  prefix, and across each boundary between non-empty ranks;
* ``perm_bad``: payloads out of range, missing or seen more than once
  (each rank sends its valid ``(val, hi, lo)`` to the rank that owns
  ``val`` by one all-to-all, and the owner counts each of its ``n``
  indices), and a valid count outside the segment;
* ``words_bad``: valid rows whose words are not the reference's own
  encoding of the owner's key bytes at ``val``.

Every count is 0 exactly when the answer is a sorted permutation of the
input.  Plain PyTorch; nothing of the program is imported.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from perfbench import reference

LIMITS = {"lost_bad": 0, "order_bad": 0, "perm_bad": 0, "words_bad": 0}
BLOCK_ROWS = 1 << 24


def _down(h: torch.Tensor, l: torch.Tensor) -> int:
    """Neighbours of ``(h, l)`` in descending order."""
    return int(((h[:-1] > h[1:]) | ((h[:-1] == h[1:]) & (l[:-1] > l[1:]))).sum())


def _all_gather(x: torch.Tensor, world: int) -> torch.Tensor:
    out = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(out, x)
    return torch.stack(out)


def check(
    keys: torch.Tensor,
    hi_s: torch.Tensor,
    lo_s: torch.Tensor,
    val_s: torch.Tensor,
    n_valid: torch.Tensor,
    lost: torch.Tensor,
    *,
    rank: int,
    world: int,
    block: int = BLOCK_ROWS,
) -> dict[str, int]:
    """The counts of the whole answer, the same on every rank: each rank
    passes its own input ``keys`` ((n, k) uint8) and its own answer.
    Collective: every rank calls it, in the same order."""
    dev = keys.device
    n = keys.shape[0]
    width = min(hi_s.shape[0], lo_s.shape[0], val_s.shape[0])
    k = int(n_valid.reshape(-1)[0])
    kv = min(max(k, 0), width)
    bad = dict.fromkeys(LIMITS, 0)
    bad["lost_bad"] = int(lost.to(torch.int64).sum())
    bad["perm_bad"] = abs(k - kv)
    hi = hi_s[:kv].to(torch.int64)
    lo = lo_s[:kv].to(torch.int64)
    val = val_s[:kv].to(torch.int64)

    for b0 in range(0, max(kv - 1, 0), block):
        b1 = min(b0 + block + 1, kv)  # one row of overlap with the next block
        bad["order_bad"] += _down(hi[b0:b1], lo[b0:b1])
    ends = torch.zeros(5, dtype=torch.int64, device=dev)
    if kv:
        ends[:] = torch.stack([torch.tensor(kv, device=dev), hi[0], lo[0], hi[-1], lo[-1]])
    ends = _all_gather(ends, world).cpu()
    if rank == 0:  # the boundaries, counted once
        prev = None
        for r in range(world):
            if ends[r, 0] == 0:
                continue
            if prev is not None:
                ph, pl, h, l = prev[3], prev[4], ends[r, 1], ends[r, 2]
                bad["order_bad"] += int(ph > h or (ph == h and pl > l))
            prev = ends[r]

    inside = (val >= 0) & (val < world * n)
    bad["perm_bad"] += int((~inside).sum())
    owner = torch.where(inside, val // n, world)  # ``world``: sent nowhere
    order = torch.sort(owner, stable=True).indices
    send_counts = torch.bincount(owner, minlength=world + 1)[:world]
    send = torch.stack([val, hi, lo], 1)[order[: int(send_counts.sum())]]
    del order, owner, inside, hi, lo, val
    recv_counts = torch.empty_like(send_counts)
    dist.all_to_all_single(recv_counts, send_counts)
    recv = torch.empty((int(recv_counts.sum()), 3), dtype=torch.int64, device=dev)
    dist.all_to_all_single(
        recv, send, output_split_sizes=recv_counts.tolist(),
        input_split_sizes=send_counts.tolist(),
    )
    del send
    local = recv[:, 0] - rank * n
    seen = torch.zeros(n, dtype=torch.int32, device=dev)
    seen.index_add_(0, local, torch.ones_like(local, dtype=torch.int32))
    # each index seen once; one seen twice leaves another unseen, so it
    # counts twice
    bad["perm_bad"] += int((seen != 1).sum())
    for b0 in range(0, recv.shape[0], block):
        b1 = min(b0 + block, recv.shape[0])
        h, l = reference.encode_words(keys[local[b0:b1]])
        bad["words_bad"] += int(((h != recv[b0:b1, 1]) | (l != recv[b0:b1, 2])).sum())

    totals = torch.tensor(list(bad.values()), dtype=torch.int64, device=dev)
    dist.all_reduce(totals)
    return dict(zip(bad, (int(v) for v in totals.cpu())))
