"""Timed paths that must come out not correct: the controls and the
planted faults.  Each is a ``sort(model, keys)`` in the harness's form,
``-> (hi, lo, perm, overflow)``, put in the program's place by
``harness.run_cell(sort=...)``.

* controls: the reference itself, computed on a key that breaks the
  configuration's order: ``hi32`` (the first 4 key bytes, an int32 key
  for the int64 one) and ``f64`` (the 8 bytes rounded to a float64);
* faults, planted under the program's own path: ``unchanged`` (the input
  returned in its own order), ``half`` (only the first half of the
  records sorted and returned), ``altered`` (one output word changed
  where it is produced), ``unstable`` (equal keys in reverse input
  order, as an unstable sort may leave them).  A cell on one chip has no
  exchange to leave out;
* faults planted in one of ``sort_device``'s two paths alone, so that a
  run catches them only by checking a call of that path: ``rows`` (the
  row sorter's kernel leaves the first two records of one row swapped)
  and ``fallback`` (the stable fallback's sort swaps its first two
  records).
"""

from __future__ import annotations

import torch

from perfbench import reference

CONTROLS = ("hi32", "f64")
FAULTS = ("unchanged", "half", "altered", "unstable")
PATH_FAULTS = ("rows", "fallback")


def _swap_first_two(ts, row=None):
    """Copies of ``ts`` with elements 0 and 1 swapped (of row ``row``
    where given)."""
    out = []
    for t in ts:
        t = t.clone()
        v = t[row] if row is not None else t
        v[[0, 1]] = v[[1, 0]]
        out.append(t)
    return tuple(out)


def _swap_in_a_full_row(out):
    """The row sorter's answer ``(hi, lo, val)`` with the first two slots
    of one row swapped: the row whose second slot holds the smallest
    record index, so a real record (empty slots hold the largest)."""
    return _swap_first_two(out, row=int(torch.argmin(out[2][:, 1])))


def _planted(kind: str, program, model, keys):
    """``program(model, keys)`` with the fault ``kind`` planted in the
    program's own module for the length of the call."""
    from repro_torch.core import learned_sort
    from repro_torch.kernels import bitonic

    if kind == "rows":
        mod, names = bitonic, ("sort_rows_cuda", "sort_rows_plain")
        wrap = lambda f: lambda *a: _swap_in_a_full_row(f(*a))  # noqa: E731
    else:
        mod, names = learned_sort, ("sort_oracle",)
        wrap = lambda f: lambda *a: _swap_first_two(f(*a))  # noqa: E731
    real = {name: getattr(mod, name) for name in names}
    for name, f in real.items():
        setattr(mod, name, wrap(f))
    try:
        return program(model, keys)
    finally:
        for name, f in real.items():
            setattr(mod, name, f)


def control(key: str):
    def sort(model, keys):
        return (*reference.stable_sort(keys, key), False)

    return sort


def fault(kind: str, program):
    """``program`` is the timed path (``harness.program_sort()``)."""

    def sort(model, keys):
        if kind == "unchanged":
            hi, lo = reference.encode_words(keys)
            perm = torch.arange(keys.shape[0], dtype=torch.int32, device=keys.device)
            return hi, lo, perm, False
        if kind == "half":
            return program(model, keys[: keys.shape[0] // 2])
        if kind == "altered":
            hi, lo, perm, overflow = program(model, keys)
            lo = lo.clone()
            lo[lo.shape[0] // 2] += 1
            return hi, lo, perm, overflow
        if kind in PATH_FAULTS:
            return _planted(kind, program, model, keys)
        if kind == "unstable":
            hi, lo = reference.encode_words(keys)
            perm = torch.arange(keys.shape[0] - 1, -1, -1, device=keys.device)
            perm = perm[torch.sort(lo[perm], stable=True).indices]
            perm = perm[torch.sort(hi[perm], stable=True).indices]
            return hi[perm], lo[perm], perm.to(torch.int32), False
        raise ValueError(f"unknown fault {kind!r}")

    return sort


def sort_for(name: str, program):
    return control(name) if name in CONTROLS else fault(name, program)


# ------------------------------------------------------------ multi-rank
#
# A rank's timed path is ``call(fn, keys, val) -> (hi_s, lo_s, val_s,
# n_valid, lost)`` (``mesh_harness.program_call``); each of these puts one
# in the program's place on every rank (``mesh_call_for``).
#
# * controls: the program with the local sort of each rank computed on a
#   key that breaks the configuration's order, ``hi32`` (the first 4 key
#   bytes) and ``f64`` (the 8 bytes rounded to a float64);
# * faults planted in one rank's answer: ``drop`` (its last record left
#   out), ``dup`` (one payload twice), ``swap`` (ranks 0 and 1 hand back
#   each other's segment), ``reverse`` (its segment reversed),
#   ``altered`` (one output word + 1), ``lost`` (one record reported
#   lost);
# * faults of the whole step: ``unchanged`` (every rank's input returned
#   in its own order), ``half`` (half of every rank's records left out)
#   and ``noexchange`` (the exchange between cards left out: each rank
#   sorts its own records, by the program's sort over a one-rank mesh).

MESH_CONTROLS = ("hi32", "f64")
MESH_FAULTS = ("drop", "dup", "swap", "reverse", "altered", "lost", "unchanged", "half",
               "noexchange")


def _local_sort(key: str):
    """``learned_sort.sort_device``'s place: a stable sort of ``(hi, lo)``
    on a key that breaks the configuration's order."""

    def sort_device(model, hi, lo, **kw):
        if key == "hi32":
            perm = torch.sort(hi, stable=True).indices
        else:
            perm = torch.sort(hi.to(torch.float64) * 4294967296.0 + lo.to(torch.float64),
                              stable=True).indices
        return hi[perm], lo[perm], perm.to(torch.int32)

    return sort_device


def _swap_with(out, peer: int):
    """``out`` exchanged whole with rank ``peer``'s (a collective of the
    two)."""
    import torch.distributed as dist

    got = [torch.empty_like(x) for x in out]
    ops = [dist.P2POp(dist.isend, x.contiguous(), peer) for x in out]
    ops += [dist.P2POp(dist.irecv, g, peer) for g in got]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return tuple(got)


def _one_rank(kind: str, out):
    """The fault ``kind`` planted in ``out`` on rank 0 (``drop``: on the
    last rank)."""
    hi, lo, val, n_valid, lost = (x.clone() for x in out)
    k = int(n_valid[0])
    if kind == "drop":
        n_valid -= 1
    elif kind == "dup":
        val[1] = val[0]
    elif kind == "reverse":
        for x in (hi, lo, val):
            x[:k] = x[:k].flip(0)
    elif kind == "altered":
        lo[k // 2] += 1
    elif kind == "lost":
        lost += 1
    return hi, lo, val, n_valid, lost


def mesh_call_for(name: str, program, st):
    """The call that puts ``name`` in the program's place on this rank;
    ``program`` is the program's own call, ``st`` the rank
    (``mesh_harness.Rank``)."""
    from repro_torch.core import distributed, learned_sort
    from repro_torch.launch import mesh

    if name == "program":
        return program
    if name in MESH_CONTROLS:
        def call(fn, keys, val):
            real = learned_sort.sort_device
            learned_sort.sort_device = _local_sort(name)
            try:
                return program(fn, keys, val)
            finally:
                learned_sort.sort_device = real

        return call
    if name in ("drop", "dup", "reverse", "altered", "lost"):
        target = st.world - 1 if name == "drop" else 0

        def call(fn, keys, val):
            out = program(fn, keys, val)
            return _one_rank(name, out) if st.rank == target else out

        return call
    if name == "swap":
        def call(fn, keys, val):
            out = program(fn, keys, val)
            return _swap_with(out, 1 - st.rank) if st.rank < 2 else out

        return call
    if name == "unchanged":
        def call(fn, keys, val):
            hi, lo = reference.encode_words(keys)
            one = torch.ones(1, dtype=torch.int32, device=keys.device)
            return hi, lo, val, one * keys.shape[0], one * 0

        return call
    if name == "half":
        def call(fn, keys, val):
            hi, lo, v, n_valid, lost = program(fn, keys, val)
            return hi, lo, v, n_valid // 2, lost

        return call
    if name == "noexchange":
        alone = mesh.DataMesh(None, 0, 1, st.dev)
        fns: dict = {}

        def call(fn, keys, val):
            n = keys.shape[0]
            if n not in fns:
                fns[n] = distributed.make_sort_fn(
                    alone, ("data",), st.model, n,
                    capacity_factor=st.cfg["capacity_factor"],
                    pre_shuffle=st.cfg["pre_shuffle"])
            return program(fns[n], keys, val)

        return call
    raise ValueError(f"unknown path {name!r}")
