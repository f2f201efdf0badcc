"""Recursive Model Index (RMI) CDF model (paper §3.1) for the PyTorch port.

Port of ``src/repro/core/rmi.py``.  A root linear model routes a key's
global feature to one of ``n_leaf`` leaf linear models; each leaf
predicts the CDF inside its own monotone band and its own two-word
feature frame (the hierarchical-precision scheme the reference's
docstring explains).

* ``fit`` / ``fit_encoded`` are copies of the reference's NumPy float64
  training code; the model they return lives on the CPU, so the host
  pipeline never touches a device.
* :func:`params_from_numpy` turns a model with NumPy leaves — the JAX
  package's ``RMIParams`` as its ``fit`` returns it — into the torch
  :class:`RMIParams`, so both packages can run one and the same model.
* ``predict_cdf`` / ``predict_bucket`` are torch, every float step its
  own rounded operation (never a fused multiply-add) and every
  float -> int32 cast saturating with NaN -> 0, as XLA's convert does.
  They are bit-equal to the reference's *eager* ``rmi.predict_bucket``.
* ``predict_cdf_np`` / ``predict_bucket_np`` are copies of the host
  twins the partition stage uses.
"""

from __future__ import annotations

import dataclasses
import functools
import types

import numpy as np
import torch

from repro_torch.core import encoding

_LEAF_FIELDS = (
    "leaf_slope", "leaf_intercept", "leaf_lo", "leaf_hi",
    "leaf_min_hi", "leaf_min_lo", "leaf_inv_range",
)
_U32_FIELDS = ("min_hi", "min_lo", "leaf_min_hi", "leaf_min_lo")


@dataclasses.dataclass(frozen=True)
class RMIParams:
    """Trained CDF model as tensors.

    u32 fields are int64-carried.  The five scalars stay 0-d CPU tensors
    wherever the leaves live: the kernels take them as launch arguments
    and torch uses a 0-d CPU tensor as a scalar beside CUDA tensors, so
    reading them never waits on the device.
    """

    min_hi: torch.Tensor  # () int64
    min_lo: torch.Tensor  # () int64
    inv_range: torch.Tensor  # () float32
    root_slope: torch.Tensor  # () float32
    root_intercept: torch.Tensor  # () float32
    leaf_slope: torch.Tensor  # (L,) float32
    leaf_intercept: torch.Tensor  # (L,) float32
    leaf_lo: torch.Tensor  # (L,) float32
    leaf_hi: torch.Tensor  # (L,) float32
    leaf_min_hi: torch.Tensor  # (L,) int64
    leaf_min_lo: torch.Tensor  # (L,) int64
    leaf_inv_range: torch.Tensor  # (L,) float32

    @property
    def n_leaf(self) -> int:
        return self.leaf_slope.shape[0]

    @property
    def device(self) -> torch.device:
        return self.leaf_slope.device

    def to(self, device) -> "RMIParams":
        """The model with its leaf tables on ``device`` (scalars stay on
        the CPU).  A model already there is returned as it is; a copy is
        made once per device and kept on this model, so every later call
        (the next sort under a cached model) returns the same copy, with
        its packed kernel table, and uploads nothing."""
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev == self.device:
            return self
        copies = self.__dict__.setdefault("_copies", {})
        if dev not in copies:
            copies[dev] = dataclasses.replace(
                self,
                **{f: getattr(self, f).to(dev) for f in _LEAF_FIELDS},
            )
        return copies[dev]

    def ftable(self) -> torch.Tensor:
        """(L, 5) f32 leaf table: slope, intercept, band lo/hi, inv_range."""
        return torch.stack(
            [
                self.leaf_slope,
                self.leaf_intercept,
                self.leaf_lo,
                self.leaf_hi,
                self.leaf_inv_range,
            ],
            dim=1,
        )

    def utable(self) -> torch.Tensor:
        """(L, 2) int64-carried u32 leaf offsets: min_hi, min_lo."""
        return torch.stack([self.leaf_min_hi, self.leaf_min_lo], dim=1)

    @functools.cached_property
    def kernel_table(self) -> torch.Tensor:
        """:func:`pack_leaf_table` on this model's device, built once per
        model and device (the RMI kernel reads it on every launch)."""
        return pack_leaf_table(self).to(self.device)


# The RMI kernel's leaf row: eight 32-bit words, 32 bytes, one sector.
# f32 fields are carried as their bit patterns, u32 fields as their low
# 32 bits; csrc/rmi.cu reads a row as two 16-byte loads in this order.
LEAF_ROW = (
    "slope", "intercept", "band_lo", "band_hi", "inv_range",
    "min_hi", "min_lo", "pad",
)
_ROW_F32 = ("leaf_slope", "leaf_intercept", "leaf_lo", "leaf_hi", "leaf_inv_range")
_ROW_U32 = ("leaf_min_hi", "leaf_min_lo")


def _u32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64-carried u32 -> int32 with the same low 32 bits (values from
    2**31 up wrap to negatives; they neither saturate nor raise)."""
    v = v.to(torch.int64) & 0xFFFFFFFF
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def pack_leaf_table(params: RMIParams) -> torch.Tensor:
    """(L, 8) int32 leaf rows in :data:`LEAF_ROW` order, on the CPU; a
    fresh contiguous tensor, so its base is aligned for 16-byte loads."""
    f = torch.stack([getattr(params, n).cpu() for n in _ROW_F32], dim=1)
    u = torch.stack([_u32_bits(getattr(params, n).cpu()) for n in _ROW_U32], dim=1)
    pad = torch.zeros(params.n_leaf, 1, dtype=torch.int32)
    return torch.cat([f.contiguous().view(torch.int32), u, pad], dim=1)


def unpack_leaf_table(table: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``(ftable(), utable())`` a packed table holds, bit for bit."""
    k = len(_ROW_F32)
    f = table[:, :k].contiguous().view(torch.float32)
    u = table[:, k : k + len(_ROW_U32)].to(torch.int64) & 0xFFFFFFFF
    return f, u


def params_from_numpy(p) -> RMIParams:
    """Torch :class:`RMIParams` (on the CPU) from any object with the
    reference's fields as NumPy-convertible leaves (the JAX package's
    ``RMIParams``, or the arrays ``fit_encoded`` computes)."""
    fields = {}
    for f in dataclasses.fields(RMIParams):
        v = np.asarray(getattr(p, f.name))
        if f.name in _U32_FIELDS:
            fields[f.name] = torch.from_numpy(v.astype(np.int64))
        else:
            fields[f.name] = torch.from_numpy(v.astype(np.float32))
    return RMIParams(**fields)


def to_numpy(params: RMIParams) -> types.SimpleNamespace:
    """The model's fields as NumPy arrays in the reference's dtypes
    (u32 words as ``uint32``, so NumPy's wrapping subtract applies)."""
    return types.SimpleNamespace(
        **{
            f.name: getattr(params, f.name).cpu().numpy().astype(
                np.uint32 if f.name in _U32_FIELDS else np.float32
            )
            for f in dataclasses.fields(RMIParams)
        }
    )


def _linfit(x: np.ndarray, y: np.ndarray) -> tuple[float, float]:
    """Least-squares line with slope clamped >= 0."""
    if len(x) == 0:
        return 0.0, 0.5
    if len(x) == 1 or float(x.max() - x.min()) == 0.0:
        return 0.0, float(y.mean())
    xm, ym = x.mean(), y.mean()
    denom = float(((x - xm) ** 2).sum())
    slope = float(((x - xm) * (y - ym)).sum()) / denom
    slope = max(slope, 0.0)
    return slope, float(ym - slope * xm)


def fit(
    sample_keys: np.ndarray,
    n_leaf: int = 1024,
    max_sample: int = 10_000_000,
) -> RMIParams:
    """Train the CDF model on a host sample of ``(N, K) uint8`` keys
    (sample capped at 10M, paper §6)."""
    if sample_keys.shape[0] > max_sample:
        idx = np.random.default_rng(0).choice(
            sample_keys.shape[0], max_sample, replace=False
        )
        sample_keys = sample_keys[idx]
    hi, lo = encoding.encode_np(sample_keys)
    return fit_encoded(hi, lo, n_leaf=n_leaf)


def fit_encoded(hi: np.ndarray, lo: np.ndarray, n_leaf: int = 1024) -> RMIParams:
    """Fit from pre-encoded ``uint32`` (hi, lo) words (NumPy float64)."""
    n = hi.shape[0]
    if n == 0:
        raise ValueError("cannot fit CDF model on an empty sample")
    order = np.lexsort((lo, hi))
    hi_s, lo_s = hi[order], lo[order]
    min_hi, min_lo = int(hi_s[0]), int(lo_s[0])
    max_hi, max_lo = int(hi_s[-1]), int(lo_s[-1])
    span = (max_hi - min_hi) * 4294967296.0 + (max_lo - min_lo)
    inv_range = 1.0 / span if span > 0 else 1.0

    x = encoding.feature_f64_np(hi_s, lo_s, min_hi, min_lo, inv_range)
    y = (np.arange(n, dtype=np.float64) + 0.5) / n  # empirical CDF

    # root: linear, slope >= 0 (fallback to identity ramp)
    rs, ri = _linfit(x, y)
    if rs <= 0.0:
        rs, ri = 1.0, 0.0

    leaf_of = np.clip((x * rs + ri) * n_leaf, 0, n_leaf - 1).astype(np.int64)

    # CDF boundary between consecutive leaves = empirical CDF at the first
    # sample routed to each leaf (empty leaves inherit the next boundary)
    starts = np.searchsorted(leaf_of, np.arange(n_leaf), side="left")
    ends = np.append(starts[1:], n)
    counts = (ends - starts).astype(np.float64)
    occupied = counts > 0
    bounds = np.empty(n_leaf + 1)
    bounds[:-1] = starts / n
    bounds[-1] = 1.0
    lo_band = bounds[:-1].copy()
    hi_band = bounds[1:].copy()

    # leaf-local feature frame: offset at the leaf's first sample, scaled
    # by the leaf's own key span
    first = np.where(occupied, starts, 0)
    last = np.where(occupied, ends - 1, 0)
    lmin_hi = hi_s[first].astype(np.uint32)
    lmin_lo = lo_s[first].astype(np.uint32)
    lspan = (hi_s[last].astype(np.float64) - hi_s[first].astype(np.float64)) \
        * 4294967296.0 + (
        lo_s[last].astype(np.float64) - lo_s[first].astype(np.float64)
    )
    linv = np.where(lspan > 0, 1.0 / np.maximum(lspan, 1e-300), 1.0)

    lmh = lmin_hi[leaf_of]
    lml = lmin_lo[leaf_of]
    borrow = (lo_s < lml).astype(np.uint64)
    dlo = (lo_s - lml).astype(np.uint64)
    dhi = (hi_s.astype(np.uint64) - lmh.astype(np.uint64) - borrow) & np.uint64(
        0xFFFFFFFF
    )
    xl = np.clip(
        (dhi.astype(np.float64) * 4294967296.0 + dlo.astype(np.float64))
        * linv[leaf_of],
        0.0,
        1.0,
    )

    # segmented least squares via reduceat (empty segments handled below)
    red = lambda v: np.add.reduceat(v, np.minimum(starts, n - 1))
    sx, sy = red(xl), red(y)
    sxx, sxy = red(xl * xl), red(xl * y)
    c = np.maximum(counts, 1.0)
    var = sxx - sx * sx / c
    cov = sxy - sx * sy / c
    with np.errstate(divide="ignore", invalid="ignore"):
        slopes = np.where(var > 1e-18, cov / np.maximum(var, 1e-300), 0.0)
    slopes = np.maximum(slopes, 0.0)
    intercepts = sy / c - slopes * sx / c
    # degenerate / empty leaves: constant at band midpoint / lower bound
    mid = 0.5 * (lo_band + hi_band)
    intercepts = np.where(slopes == 0.0, np.where(occupied, mid, lo_band),
                          intercepts)
    slopes = np.where(occupied, slopes, 0.0)

    f32 = lambda v: np.asarray(v, dtype=np.float32)
    u32 = lambda v: np.asarray(v, dtype=np.uint32)
    return params_from_numpy(types.SimpleNamespace(
        min_hi=u32(min_hi),
        min_lo=u32(min_lo),
        inv_range=f32(inv_range),
        root_slope=f32(rs),
        root_intercept=f32(ri),
        leaf_slope=f32(slopes),
        leaf_intercept=f32(intercepts),
        leaf_lo=f32(lo_band),
        leaf_hi=f32(hi_band),
        leaf_min_hi=u32(lmin_hi),
        leaf_min_lo=u32(lmin_lo),
        leaf_inv_range=f32(linv),
    ))


def f32_to_i32(v: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 by truncation with XLA's saturation: values past
    the int32 range clamp to its ends and NaN becomes 0 (a plain torch
    cast of an out-of-range float is undefined)."""
    v = torch.nan_to_num(v.to(torch.float64), nan=0.0)
    return v.clamp(-2147483648.0, 2147483647.0).to(torch.int64).to(torch.int32)


def predict_cdf(params: RMIParams, hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Monotone CDF prediction F(x) in [0, 1] (plain torch; the kernel is
    ``kernels/rmi.py``)."""
    x = encoding.feature_f32(hi, lo, params.min_hi, params.min_lo, params.inv_range)
    n_leaf = params.n_leaf
    r = (x * params.root_slope + params.root_intercept) * n_leaf
    leaf = f32_to_i32(r).clamp(0, n_leaf - 1).to(torch.int64)
    xl = encoding.feature_f32(
        hi,
        lo,
        params.leaf_min_hi[leaf],
        params.leaf_min_lo[leaf],
        params.leaf_inv_range[leaf],
    )
    y = xl * params.leaf_slope[leaf] + params.leaf_intercept[leaf]
    return torch.clamp(y, params.leaf_lo[leaf], params.leaf_hi[leaf])


def predict_bucket(
    params: RMIParams, hi: torch.Tensor, lo: torch.Tensor, n_buckets: int
) -> torch.Tensor:
    """Equi-depth bucket id in [0, n_buckets) (paper §3.3), int32."""
    y = predict_cdf(params, hi, lo)
    return torch.clamp(f32_to_i32(y * n_buckets), max=n_buckets - 1)


def predict_cdf_np(
    params: RMIParams, hi: np.ndarray, lo: np.ndarray
) -> np.ndarray:
    """NumPy twin for the host-side (file streaming) pipeline."""
    p = to_numpy(params)
    x = encoding.feature_f64_np(
        hi, lo, int(p.min_hi), int(p.min_lo), float(p.inv_range)
    ).astype(np.float32)
    n_leaf = len(p.leaf_slope)
    leaf = np.clip(
        ((x * p.root_slope + p.root_intercept) * n_leaf).astype(np.int32),
        0,
        n_leaf - 1,
    )
    lmh = p.leaf_min_hi[leaf]
    lml = p.leaf_min_lo[leaf]
    below = (hi < lmh) | ((hi == lmh) & (lo < lml))
    borrow = (lo < lml).astype(np.uint64)
    dlo = (lo - lml).astype(np.uint64)
    dhi = (hi.astype(np.uint64) - lmh.astype(np.uint64) - borrow) & np.uint64(
        0xFFFFFFFF
    )
    xl = dhi.astype(np.float64) * 4294967296.0 + dlo.astype(np.float64)
    xl = np.where(
        below, 0.0, np.clip(xl * p.leaf_inv_range[leaf], 0.0, 1.0)
    ).astype(np.float32)
    y = xl * p.leaf_slope[leaf] + p.leaf_intercept[leaf]
    return np.clip(y, p.leaf_lo[leaf], p.leaf_hi[leaf])


def predict_bucket_np(
    params: RMIParams, hi: np.ndarray, lo: np.ndarray, n_buckets: int
) -> np.ndarray:
    y = predict_cdf_np(params, hi, lo)
    return np.minimum((y * n_buckets).astype(np.int32), n_buckets - 1)
