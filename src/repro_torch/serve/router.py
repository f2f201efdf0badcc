"""Key-range routing across shard manifests with replica round-robin
(copy of ``src/repro/serve/router.py``; DESIGN.md §14).

A sharded corpus is a set of sorted runs with **disjoint, ordered key
ranges** — the shape ``terasort.sort_file_distributed`` produces per
host range (and any user-side range split produces by construction).
Each shard may be served by several identical replicas (same bytes,
same manifest hash).  The router

1. orders the shards by their first record key and validates that
   ranges do not interleave (shard *i*'s last key must precede shard
   *i+1*'s first key),
2. routes a point key to the single shard whose span can contain it
   (``searchsorted`` over the shard start keys — the same boundary-key
   discipline the in-file partition fallback uses, one level up),
3. splits an inclusive range query at shard start keys so each shard
   scans only its own span, concatenating in shard (= key) order, and
4. spreads load inside a shard across its replicas round-robin — every
   replica holds identical bytes, so rotation never changes an answer.
"""

from __future__ import annotations

import itertools
import threading

from repro_torch.serve.index import SortedFileIndex


class ShardRouter:
    """Boundary-key dispatch over ordered shard groups."""

    def __init__(self, shard_groups: "list[list[SortedFileIndex]]"):
        groups = [list(g) for g in shard_groups if g]
        if not groups:
            raise ValueError("ShardRouter needs at least one shard group")
        for g in groups:
            h0 = g[0].manifest.model_hash
            n0 = g[0].n
            for rep in g[1:]:
                if rep.manifest.model_hash != h0 or rep.n != n0:
                    raise ValueError(
                        f"replica mismatch inside a shard group: "
                        f"{rep.path!r} does not carry the same manifest "
                        f"as {g[0].path!r} (hash/count differ)"
                    )
        # order shards by first key; empty shards sort first and are
        # never routed to (their span is empty)
        groups.sort(key=lambda g: g[0].min_key())
        self.groups = groups
        self._lo = [g[0].min_key() for g in groups]
        prev_hi, prev = None, None
        for g in groups:
            if g[0].n == 0:
                continue
            if prev_hi is not None and g[0].min_key() <= prev_hi:
                raise ValueError(
                    f"shard key ranges interleave: {prev!r} ends at "
                    f"{prev_hi!r} but {g[0].path!r} starts at "
                    f"{g[0].min_key()!r} — routing by boundary key "
                    f"needs disjoint ordered shards"
                )
            prev_hi, prev = g[0].max_key(), g[0].path
        self._rr = [itertools.cycle(range(len(g))) for g in groups]
        self._rr_lock = threading.Lock()

    @property
    def n_shards(self) -> int:
        return len(self.groups)

    @property
    def n(self) -> int:
        """Total records across shards (one replica each)."""
        return sum(g[0].n for g in self.groups)

    def pick(self, sid: int) -> SortedFileIndex:
        """The next replica of shard ``sid`` (round-robin)."""
        with self._rr_lock:
            return self.groups[sid][next(self._rr[sid])]

    def shard_for_key(self, key: bytes) -> int:
        """The shard whose span can contain ``key``: the last shard
        whose first key is <= key (keys before every shard route to
        shard 0 and simply miss there)."""
        lo = 0
        for i, k in enumerate(self._lo):
            if k <= key:
                lo = i
            else:
                break
        return lo

    def split_range(
        self, lo_key: bytes, hi_key: bytes
    ) -> "list[tuple[int, bytes, bytes]]":
        """Decompose the inclusive range ``[lo_key, hi_key]`` into
        per-shard sub-ranges, in key order.  Each shard receives the
        intersection of the query with its span, clamped so no shard
        scans keys another shard owns."""
        if hi_key < lo_key:
            return [(self.shard_for_key(lo_key), lo_key, hi_key)]
        first = self.shard_for_key(lo_key)
        out = []
        for sid in range(first, len(self.groups)):
            if self.groups[sid][0].n == 0:
                continue
            s_lo = self._lo[sid]
            if s_lo > hi_key:
                break
            s_hi = self.groups[sid][0].max_key()
            if s_hi < lo_key:
                continue
            out.append((sid, max(lo_key, s_lo), min(hi_key, s_hi)))
        return out or [(first, lo_key, hi_key)]
