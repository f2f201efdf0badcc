"""LearnedSort (paper §3.4): the host sort and the comparison oracle
(port of ``src/repro/core/learned_sort.py``).

``sort_device`` — the per-partition device chain — is not ported yet;
the batched executor's grid graph (``kernels/fused.py``) is the port's
device path.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import encoding, rmi


def sort_oracle(
    hi: torch.Tensor, lo: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reference comparison sort: stable by (hi, lo); returns the sorted
    words and the int32 permutation."""
    perm = torch.sort(encoding.packed_key(hi, lo), stable=True).indices
    return hi[perm], lo[perm], perm.to(torch.int32)


def sort_host(model: rmi.RMIParams, keys: np.ndarray) -> np.ndarray:
    """Host (NumPy) LearnedSort for the CPU file pipeline: returns
    ``perm`` sorting ``keys`` (N, K u8) in memcmp order (a copy of the
    reference's):

      1. the RMI predicts an equi-depth minor bucket per key,
      2. a stable integer sort groups by bucket (the counting-sort
         placement),
      3. one stable mergesort pass over the full keys of the now
         nearly-sorted array fixes model error and bytes beyond the
         8-byte embedding.
    """
    n = keys.shape[0]
    if n <= 1:
        return np.arange(n)
    hi, lo = encoding.encode_np(keys)
    n_buckets = max(64, 1 << max(0, (n // 256 - 1)).bit_length())
    b = rmi.predict_bucket_np(model, hi, lo, n_buckets)
    perm = np.argsort(b, kind="stable")
    k = np.ascontiguousarray(keys[perm]).view(
        [("k", f"S{keys.shape[1]}")]
    )["k"].reshape(-1)
    if (k[:-1] > k[1:]).any():
        perm = perm[np.argsort(k, kind="stable")]
    return perm
