"""gensort's key rule, made on the device from a seed.

A frozen copy of the rule in ``src/repro_torch/data/gensort.py`` (the
program's generator is not imported, so a change to it cannot move the
yardstick):

* every key byte i.i.d. uniform over the printable range
  ``[ascii_lo, ascii_hi]`` (gensort ``-a``);
* skewed (gensort ``-a -s``): record ``idx``'s first ``table_bytes`` key
  bytes are ``table[floor(log2(max(idx, 1))) mod table_size]``, the table
  itself stored in the configuration's file.

Records are drawn at seeded random indices of a ``file_records`` file
that is never written, so an array spans the model's whole key range and
holds the skewed file's spikes in their published shares.
"""

from __future__ import annotations

import torch

CHUNK = 1 << 24  # records made by one call of the generator


def skew_table(cfg: dict, device) -> "torch.Tensor | None":
    """(table_size, table_bytes) uint8 skew table of ``cfg``, or None."""
    skew = cfg.get("skew")
    if not skew:
        return None
    rows = [bytes.fromhex(h) for h in skew["table_hex"]]
    if len(rows) != skew["table_size"] or any(
        len(r) != skew["table_bytes"] for r in rows
    ):
        raise ValueError("skew table does not match its stated shape")
    return torch.tensor([list(r) for r in rows], dtype=torch.uint8, device=device)


def log2_floor(idx: torch.Tensor) -> torch.Tensor:
    """floor(log2(max(idx, 1))) of int64 indices below 2**53, exactly
    (``frexp`` gives ``x = m * 2**e`` with ``m`` in [0.5, 1))."""
    _, e = torch.frexp(idx.clamp(min=1).to(torch.float64))
    return e.to(torch.int64) - 1


def keys_at(
    idx: torch.Tensor, cfg: dict, gen: torch.Generator
) -> torch.Tensor:
    """(n, key_bytes) uint8 keys of the records at file indices ``idx``."""
    n = idx.shape[0]
    keys = torch.randint(
        cfg["ascii_lo"], cfg["ascii_hi"] + 1, (n, cfg["key_bytes"]),
        dtype=torch.uint8, generator=gen, device=idx.device,
    )
    table = skew_table(cfg, idx.device)
    if table is not None:
        row = log2_floor(idx) % table.shape[0]
        keys[:, : table.shape[1]] = table[row]
    return keys


def random_records(
    n: int, cfg: dict, gen: torch.Generator, device
) -> torch.Tensor:
    """(n, key_bytes) keys of ``n`` records at seeded random indices,
    made :data:`CHUNK` records at a time, which bounds the temporaries."""
    keys = torch.empty((n, cfg["key_bytes"]), dtype=torch.uint8, device=device)
    for s in range(0, n, CHUNK):
        e = min(n, s + CHUNK)
        idx = torch.randint(
            0, cfg["file_records"], (e - s,), dtype=torch.int64,
            generator=gen, device=device,
        )
        keys[s:e] = keys_at(idx, cfg, gen)
    return keys


def sample_indices(cfg: dict, device) -> torch.Tensor:
    """File indices of the training sample, drawn as the port's Sample
    stage draws it (``core/format.py`` ``sample_keys``): ``frac`` of the
    file, at least ``min``, at most ``max``, as contiguous runs from
    ``stripes`` evenly spaced offsets."""
    s, n = cfg["sample"], cfg["file_records"]
    take = min(max(int(n * s["frac"]), s["min"]), s["max"], n)
    per = max(take // s["stripes"], 16)
    runs = []
    for k in range(s["stripes"]):
        start = int(k * n / s["stripes"])
        runs.append(torch.arange(start, min(start + per, n), device=device))
    idx = torch.cat(runs)
    if idx.shape[0] > take:
        raise ValueError("sample stripes exceed the sample size")
    return idx
