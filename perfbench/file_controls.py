"""Timed paths of the file sort that must come out not correct: the
controls and the planted faults.  Each is a ``sort(input, output,
config) -> SortStats | None`` in the file-sort driver's form, put in the
program's place by its ``run(sort=...)``.

* controls: the reference itself (:mod:`file_reference`), a stable sort
  that breaks the configuration's order: ``hi32`` orders by the first 4
  key bytes, ``prefix8`` by the first 8, with no touch-up past them (the
  skewed file's spike fixes 6 bytes, so 8-byte prefixes tie);
* faults planted in the program's output file, after its ``sort_file``
  and before the driver's fsync: ``drop`` (the last record left out),
  ``dup`` (the middle record written over its successor), ``swap`` (two
  neighbours with different keys exchanged), ``unstable`` (two
  neighbours with the same key exchanged), ``altered`` (one filler byte
  + 1), ``truncated`` (the file cut to half its records); and
  ``unchanged`` (the input copied to the output: a sort that does
  nothing).
"""

from __future__ import annotations

import shutil

import numpy as np
import torch

from perfbench import file_reference, gensort_file

CONTROLS = {"hi32": 4, "prefix8": 8}
FAULTS = ("drop", "dup", "swap", "unstable", "altered", "unchanged", "truncated")
PATHS = (*CONTROLS, *FAULTS)


def control(key_bytes: int):
    def sort(inp, out, config):
        rec, _ = file_reference.read_file(inp, torch.device(config.device))
        rec = rec[file_reference.stable_order(rec, key_bytes)]
        rec.cpu().numpy().tofile(out)
        return None

    return sort


def _neighbours(rec: np.ndarray, key_bytes: int, same: bool) -> int:
    """The first ``i`` from the middle on whose record and its successor
    have equal keys (``same``) or different ones."""
    k = rec[:, :key_bytes]
    eq = (k[:-1] == k[1:]).all(1) & (rec[:-1] != rec[1:]).any(1)
    hits = np.flatnonzero(eq == same)
    hits = np.concatenate([hits[hits >= rec.shape[0] // 2], hits])
    if not hits.size:
        raise ValueError(f"no neighbours with {'equal' if same else 'different'} keys")
    return int(hits[0])


def plant(kind: str, inp, out, key_bytes: int) -> None:
    """Plant the fault ``kind`` in the sorted file ``out``."""
    if kind == "unchanged":
        shutil.copyfile(inp, out)
        return
    size = np.memmap(out, dtype=np.uint8, mode="r").shape[0]
    n = size // gensort_file.RECORD_BYTES
    if kind in ("drop", "truncated"):
        with open(out, "r+b") as f:
            f.truncate((n - 1 if kind == "drop" else n // 2) * gensort_file.RECORD_BYTES)
        return
    rec = np.memmap(out, dtype=np.uint8, mode="r+").reshape(n, -1)
    i = n // 2
    if kind == "dup":
        rec[i + 1] = rec[i]
    elif kind in ("swap", "unstable"):
        i = _neighbours(rec, key_bytes, same=kind == "unstable")
        rec[[i, i + 1]] = rec[[i + 1, i]]
    elif kind == "altered":
        rec[i, gensort_file.FILLER_AT] += 1
    else:
        raise ValueError(f"unknown fault {kind!r}")
    rec.flush()
    del rec


def fault(kind: str, program):
    """``program`` is the driver's timed path, ``sort_file``."""
    if kind not in FAULTS:
        raise ValueError(f"unknown fault {kind!r}")

    def sort(inp, out, config):
        stats = None if kind == "unchanged" else program(inp, out, config)
        plant(kind, inp, out, gensort_file.KEY_BYTES)
        return stats

    return sort


def sort_for(name: str, program):
    return control(CONTROLS[name]) if name in CONTROLS else fault(name, program)
