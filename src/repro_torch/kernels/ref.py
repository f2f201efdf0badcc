"""Plain PyTorch oracles for every kernel (port of
``src/repro/kernels/ref.py``): what the tests hold the wrappers to."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import encoding, rmi
from repro_torch.core.encoding import packed_key


def encode_ref(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, K) u8 -> (hi, lo) int64-carried u32."""
    return encoding.encode(keys)


def rmi_bucket_ref(
    params: rmi.RMIParams, hi: torch.Tensor, lo: torch.Tensor, n_buckets: int
) -> torch.Tensor:
    return rmi.predict_bucket(params, hi, lo, n_buckets)


def histogram_ref(bucket_ids: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """(n_buckets,) int32 counts.  Equal to the reference's
    ``.at[ids].add(1)`` on in-range ids; an id outside ``[0, n_buckets)``
    is dropped, as the reference's wrapper and kernel drop it together
    (``.at[-1]`` alone would wrap it onto the last bucket)."""
    ids = np.asarray(bucket_ids, dtype=np.int64)
    ids = ids[(ids >= 0) & (ids < n_buckets)]
    return torch.from_numpy(
        np.bincount(ids, minlength=n_buckets).astype(np.int32)
    )


def sort_rows_ref(
    hi: torch.Tensor, lo: torch.Tensor, val: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Row-wise stable sort by (hi, lo) — val is carried in input order
    among equal keys (the reference's ``lax.sort(num_keys=2)``)."""
    perm = torch.argsort(packed_key(hi, lo), dim=1, stable=True)
    return hi.gather(1, perm), lo.gather(1, perm), val.gather(1, perm)


def segmented_sort_ref(seg, hi, lo) -> np.ndarray:
    """Stable (seg, hi, lo)-ascending permutation — the NumPy oracle for
    ``core/learned_sort.fused_segmented_sort`` (ties keep input order)."""
    return np.lexsort(
        (np.asarray(lo), np.asarray(hi), np.asarray(seg))
    ).astype(np.int32)
