"""Public wrappers around the port's kernels (port of
``src/repro/kernels/ops.py``).

Each wrapper keeps the reference's padding contract and picks its path
from the device of the tensor it is given: a CUDA tensor launches the
hand-written kernel (and a failed build or launch raises); a CPU tensor
takes the kernel's plain PyTorch version.  There is no other switch and
no fallback from one to the other.

Each wrapper counts its kernel launches in a plain ``int`` attribute
(``encode_keys.launches``, ...), bumped only where the kernel launches,
so a run can show that its main path went through the kernels;
``bucket_histogram.strategy_launches`` splits its count by the strategy
each launch took (``histogram.STRATEGIES``).
:func:`reset_launches` sets every count to 0, and the counters of the
callers above the kernels that register with it (``COUNTER_RESETS``):
one call starts every count of the device path at 0.

``encode_keys``, ``rmi_bucket`` and ``sort_rows`` each run inside a
``repro_torch.<name>`` profiler span (``core.stages.stats.span``).
"""

from __future__ import annotations

import torch

from repro_torch.core import rmi as rmi_lib
from repro_torch.core.encoding import ENCODED_BYTES, SENTINEL
from repro_torch.core.stages.stats import span
from repro_torch.kernels import bitonic, encode, histogram, rmi

_INT32_MAX = 2**31 - 1


def _require_cpu(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cpu":
        raise ValueError(f"{what}: no kernel for device {t.device}")


def encode_keys(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, K) uint8 keys -> (hi, lo) int64-carried u32 words; keys are
    zero-padded or truncated to the 8 encoded bytes."""
    with span("repro_torch.encode_keys"):
        w = keys.shape[1]
        if w < ENCODED_BYTES:
            keys = torch.nn.functional.pad(keys, (0, ENCODED_BYTES - w))
        keys = keys[:, :ENCODED_BYTES].contiguous()
        if keys.is_cuda:
            encode_keys.launches += 1
            return encode.encode_cuda(keys)
        _require_cpu(keys, "encode_keys")
        return encode.encode_plain(keys)


def rmi_bucket(
    params: rmi_lib.RMIParams,
    hi: torch.Tensor,
    lo: torch.Tensor,
    n_buckets: int,
) -> torch.Tensor:
    """Fused RMI inference + equi-depth bucket id, (N,) int32."""
    with span("repro_torch.rmi_bucket"):
        if hi.is_cuda:
            rmi_bucket.launches += 1
            return rmi.rmi_bucket_cuda(params, hi, lo, n_buckets)
        _require_cpu(hi, "rmi_bucket")
        return rmi.rmi_bucket_plain(params, hi, lo, n_buckets)


def rmi_bucket_pair(
    params: rmi_lib.RMIParams,
    hi_a: torch.Tensor,
    lo_a: torch.Tensor,
    hi_b: torch.Tensor,
    lo_b: torch.Tensor,
    n_buckets: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dual-input bucketing: both co-partitioned inputs' keys through ONE
    :func:`rmi_bucket` call (one kernel launch, counted once), split
    back after.  The bucket id is a function of the key alone, so the
    two inputs can share one batch (DESIGN.md §9)."""
    n_a = hi_a.shape[0]
    out = rmi_bucket(
        params, torch.cat([hi_a, hi_b]), torch.cat([lo_a, lo_b]), n_buckets
    )
    return out[:n_a], out[n_a:]


def rmi_predict_pos(
    params: rmi_lib.RMIParams,
    hi: torch.Tensor,
    lo: torch.Tensor,
    n_records: int,
) -> torch.Tensor:
    """Predicted row of each key in a sorted ``n_records`` file: the
    serving hot path.  The learned index's prediction is the equi-depth
    bucket id at ``n_buckets == n_records``, so this is the RMI kernel
    unchanged (f32 makes the row exact below 2**24 records; above that
    the manifest's error band absorbs the rounding)."""
    return rmi_bucket(params, hi, lo, n_records)


def bucket_histogram(ids: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """(n_buckets,) int32 per-bucket counts of (N,) int32 ids; ids outside
    ``[0, n_buckets)`` never count (the reference's -1 padding).  A launch
    is counted in ``launches`` and, under the strategy it took, in
    ``strategy_launches``.  A ``meta`` tensor (a dry run's trace) takes
    the plain version: no data, so only the shape."""
    if ids.is_cuda:
        geo = histogram.device_geometry(n_buckets, ids.device)
        counts = histogram.histogram_cuda(ids.contiguous(), n_buckets, geo)
        bucket_histogram.launches += 1
        bucket_histogram.strategy_launches[geo.strategy] += 1
        return counts
    if not ids.is_meta:
        _require_cpu(ids, "bucket_histogram")
    return histogram.histogram_plain(ids, n_buckets)


def sort_rows(
    hi: torch.Tensor, lo: torch.Tensor, val: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Row-wise ``(hi, lo, val)``-ascending sort.  Rows are padded to a
    power-of-two width with SENTINEL keys and max-val payloads, which
    lose every tiebreak against real data, and sliced back after."""
    with span("repro_torch.sort_rows"):
        r, c = hi.shape
        c_pow2 = 1 << (c - 1).bit_length()
        if c_pow2 != c:
            pad = (0, c_pow2 - c)
            hi = torch.nn.functional.pad(hi, pad, value=SENTINEL)
            lo = torch.nn.functional.pad(lo, pad, value=SENTINEL)
            val = torch.nn.functional.pad(val, pad, value=_INT32_MAX)
        if hi.is_cuda:
            sort_rows.launches += 1
            out = bitonic.sort_rows_cuda(
                hi.contiguous(), lo.contiguous(), val.contiguous()
            )
        else:
            _require_cpu(hi, "sort_rows")
            out = bitonic.sort_rows_plain(hi, lo, val)
        return tuple(t[:, :c] for t in out)


KERNEL_WRAPPERS = (encode_keys, rmi_bucket, sort_rows, bucket_histogram)
# resets of the callers' counters (``core.learned_sort.reset_counters``),
# appended by their modules: the kernels import none of their callers
COUNTER_RESETS: list = []


def reset_launches() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
    bucket_histogram.strategy_launches = dict.fromkeys(histogram.STRATEGIES, 0)
    for reset in COUNTER_RESETS:
        reset()


reset_launches()
