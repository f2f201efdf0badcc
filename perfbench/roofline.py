"""Peaks of the card and the least bytes of each kernel's work.

A kernel's least time is the bytes its work needs over the card's peak
bandwidth: each byte of its inputs read once and each byte of its
outputs written once, at their least widths, counted from the call's
records and never from the program's grid slots.  So the yardstick reads
the same work whatever implements it: a grid with fewer empty slots, or
narrower words, shows as a higher share.
"""

from __future__ import annotations

# NVIDIA's data sheet, H100 SXM5 80 GB, at its 700 W limit.  A card's link
# to the others, a direction: NVLink 4 (18 links, 900 GB/s both ways) where
# nvidia-smi shows the cards joined by NVLink, PCIe Gen5 x16 otherwise.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "nvlink_bytes_per_s": 450e9,
        "pcie_bytes_per_s": 64e9,
    },
}

KEY_WORD_BYTES = 8  # the two 32-bit words of a key's first 8 bytes
INDEX_BYTES = 4  # an int32 record index or bucket id
PAYLOAD_BYTES = 4  # an int32 payload: the record's global index
LEAF_BYTES = 28  # a leaf: slope, intercept, band lo/hi, 1/range (f32), min hi/lo (u32)


def hbm_bytes_per_s(device_name: str) -> "float | None":
    peak = PEAKS.get(device_name)
    return None if peak is None else peak["hbm_bytes_per_s"]


def rmi_bytes(n: int, n_leaf: int) -> int:
    """RMI inference of ``n`` keys: the key words in, a bucket id out,
    and every leaf read once."""
    return n * (KEY_WORD_BYTES + INDEX_BYTES) + n_leaf * LEAF_BYTES


def sort_rows_bytes(n: int) -> int:
    """Row sort of ``n`` records: key words and record index in, the
    same out."""
    return 2 * n * (KEY_WORD_BYTES + INDEX_BYTES)


def link_bytes_per_s(device_name: str, link: "str | None") -> "float | None":
    """A card's peak bytes a second out to the others over ``link``
    (``nvlink`` or ``pcie``), or None where either is unknown."""
    peak = PEAKS.get(device_name, {})
    return peak.get(f"{link}_bytes_per_s") if link else None


def exchange_bytes(n_rank: int, world: int) -> float:
    """The least bytes a rank sends in a distributed sort of ``n_rank``
    records a rank: the key words and payload of the ``(world - 1) /
    world`` of its records that belong to other ranks, once."""
    return n_rank * (world - 1) / world * (KEY_WORD_BYTES + PAYLOAD_BYTES)
