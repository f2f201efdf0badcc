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
