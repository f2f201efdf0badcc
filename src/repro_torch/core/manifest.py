"""Sidecar manifest over sorted ELSAR output (port of
``src/repro/core/manifest.py``; DESIGN.md §7, §8).

The CDF model that partitioned the input is already a learned index
over the sorted output, which is a concatenation of monotone equi-depth
partitions.  ``<output>.manifest.npz`` persists what serving needs: the
model, the record format, per-partition counts, each partition's first
key, the offsets sidecar of line output, a measured prediction error
band ``(err_lo, err_hi)`` and (v3+) the model's content hash.

The file layout is the reference's, field for field, so a manifest
written by either package loads in the other: the model's arrays are
stored in the reference's dtypes (``uint32`` words, ``float32`` floats,
through :func:`repro_torch.core.rmi.to_numpy`), and :func:`model_hash`
hashes exactly those arrays, so both packages give one model one hash.

Version policy: ``MANIFEST_VERSION`` is one integer, bumped on any
incompatible layout change.  ``load`` reads v3 and the two older
layouts: v1 predates the record-format layer (gensort 100/10, no
offsets sidecar); v2 predates the model hash, which ``load`` recomputes.
Any other version is refused — manifests are derived data; re-sort or
re-emit them with ``build``/``save``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import types

import numpy as np

from repro_torch.core import encoding, rmi
from repro_torch.core import format as format_lib

MANIFEST_VERSION = 3
# versions load() understands: current + the two older layouts
_READABLE_VERSIONS = (1, 2, 3)

# error-band slack on top of the sampled max error: absorbs duplicates
# whose leftmost occurrence sits before the sampled one, and f32 rounding
_ERR_PAD = 32

_MODEL_FIELDS = tuple(f.name for f in dataclasses.fields(rmi.RMIParams))


def manifest_path(sorted_path: str) -> str:
    return sorted_path + ".manifest.npz"


def model_hash(model: rmi.RMIParams) -> str:
    """Content hash of a trained model: sha256 over every parameter
    array's name, dtype, shape and bytes, in the reference's dtypes.
    Equal hashes <=> the two sorts bucketed keys identically <=> their
    outputs are co-partitioned."""
    arrays = rmi.to_numpy(model)
    h = hashlib.sha256()
    for name in _MODEL_FIELDS:
        a = getattr(arrays, name)
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())  # "()" for the scalars
        h.update(memoryview(np.ascontiguousarray(a)).cast("B"))
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class SortManifest:
    """Everything needed to serve point/range queries over sorted output.
    ``model`` is the torch :class:`RMIParams`, on the CPU."""

    version: int
    n_records: int
    part_counts: np.ndarray  # (P,) int64 records per partition
    boundary_keys: np.ndarray  # (P, key_width) uint8 first key per partition
    err_lo: int  # max observed (pred - true) overshoot, in records
    err_hi: int  # max observed (true - pred) undershoot, in records
    model: rmi.RMIParams
    # record layout of the sorted file (v1 manifests: gensort 100/10)
    fmt: "format_lib.FixedFormat | format_lib.LineFormat" = format_lib.GENSORT
    # (n + 1,) record-start byte offsets for variable-length output
    line_offsets: np.ndarray | None = None
    # sha256 of the model arrays (v3+; recomputed on load for v1/v2)
    model_hash: str = ""

    @property
    def n_partitions(self) -> int:
        return int(self.part_counts.shape[0])

    def part_starts(self) -> np.ndarray:
        """(P + 1,) record-index start of each partition (+ end sentinel)."""
        return np.concatenate(
            [[0], np.cumsum(self.part_counts)]
        ).astype(np.int64)

    def part_byte_offsets(self) -> np.ndarray:
        """(P + 1,) byte offset of each partition in the sorted file."""
        if self.fmt.kind == "line":
            return np.asarray(self.line_offsets, dtype=np.int64)[
                self.part_starts()
            ]
        return self.part_starts() * self.fmt.record_bytes


def build(
    model: rmi.RMIParams,
    part_counts: "list[int] | np.ndarray",
    sorted_path: str,
    *,
    fmt=None,
    max_scan: int = 1 << 20,
) -> SortManifest:
    """Measure boundaries + error band over a freshly sorted file: one
    mostly sequential pass over at most ``max_scan`` stride-sampled
    records (exact when the file is smaller).  For line formats the pass
    also materializes the offsets sidecar."""
    fmt = fmt if fmt is not None else format_lib.GENSORT
    block = fmt.read_block(sorted_path)
    n = block.n_records
    counts = np.asarray(part_counts, dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)

    # boundary key = first key of the partition; empty partitions inherit
    # the next non-empty one (monotone), trailing empties sort after all
    p = counts.shape[0]
    boundaries = np.full((p, fmt.key_width), 0xFF, dtype=np.uint8)
    nonempty = counts > 0
    if nonempty.any():
        boundaries[nonempty] = block.keys[starts[nonempty]]
        for j in range(p - 2, -1, -1):
            if not nonempty[j] and starts[j] < n:
                boundaries[j] = boundaries[j + 1]

    err_lo = err_hi = 0
    if n:
        stride = max(1, -(-n // max_scan))
        pos = np.arange(0, n, stride, dtype=np.int64)
        hi, lo = encoding.encode_np(block.keys[pos])
        cdf = rmi.predict_cdf_np(model, hi, lo)
        pred = np.clip((cdf.astype(np.float64) * n).astype(np.int64), 0, n - 1)
        delta = pred - pos
        err_lo = int(max(0, delta.max())) + _ERR_PAD + stride
        err_hi = int(max(0, -delta.min())) + _ERR_PAD + stride

    return SortManifest(
        version=MANIFEST_VERSION,
        n_records=n,
        part_counts=counts,
        boundary_keys=boundaries,
        err_lo=err_lo,
        err_hi=err_hi,
        model=model,
        fmt=fmt,
        line_offsets=(
            np.asarray(block.offsets, dtype=np.int64)
            if fmt.kind == "line"
            else None
        ),
        model_hash=model_hash(model),
    )


def save(m: SortManifest, path: str) -> None:
    """Persist as a single ``.npz`` (no deps beyond numpy)."""
    payload = {
        "version": np.int64(m.version),
        "n_records": np.int64(m.n_records),
        "part_counts": m.part_counts,
        "boundary_keys": m.boundary_keys,
        "err_lo": np.int64(m.err_lo),
        "err_hi": np.int64(m.err_hi),
    }
    payload["model_hash"] = np.array(m.model_hash)
    payload.update(m.fmt.manifest_fields())
    if m.line_offsets is not None:
        payload["line_offsets"] = np.asarray(m.line_offsets, dtype=np.int64)
    arrays = rmi.to_numpy(m.model)
    for name in _MODEL_FIELDS:
        payload["rmi_" + name] = getattr(arrays, name)
    with open(path, "wb") as fh:
        np.savez(fh, **payload)


def load(path: str) -> SortManifest:
    with np.load(path) as z:
        version = int(z["version"])
        if version not in _READABLE_VERSIONS:
            raise ValueError(
                f"manifest {path!r} has format version {version}, this "
                f"build reads {_READABLE_VERSIONS}; re-emit the manifest "
                f"(manifests are derived data — re-sort or rebuild)"
            )
        # v1 predates the record-format layer: always gensort 100/10
        fmt = (
            format_lib.GENSORT
            if version == 1
            else format_lib.from_manifest_fields(z)
        )
        model = rmi.params_from_numpy(
            types.SimpleNamespace(
                **{name: z["rmi_" + name] for name in _MODEL_FIELDS}
            )
        )
        return SortManifest(
            version=version,
            n_records=int(z["n_records"]),
            part_counts=z["part_counts"].astype(np.int64),
            boundary_keys=z["boundary_keys"],
            err_lo=int(z["err_lo"]),
            err_hi=int(z["err_hi"]),
            model=model,
            fmt=fmt,
            line_offsets=(
                z["line_offsets"].astype(np.int64)
                if "line_offsets" in z.files
                else None
            ),
            # v1/v2 predate the stored hash: recompute from the arrays
            model_hash=(
                str(z["model_hash"])
                if "model_hash" in z.files
                else model_hash(model)
            ),
        )
