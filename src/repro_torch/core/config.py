"""The public configuration surface of the port (port of the sort half of
``src/repro/core/config.py``; DESIGN.md §14).

* :class:`SortConfig` — one file-to-file sort, with the reference's
  fields and defaults plus ``device``: ``"cuda"`` by default, so the
  entry points run on the card unless the caller asks for ``"cpu"``.
* :class:`ExecutorConfig` — the sort-executor seam
  (``core/executor.make_executor``).

Bare legacy keywords to ``sort_file`` still work through
:func:`coerce_sort_config` (one ``DeprecationWarning`` per process).
"""

from __future__ import annotations

import dataclasses
import warnings


@dataclasses.dataclass(frozen=True)
class SortConfig:
    """Every knob of one ``sort_file`` run.  Field semantics are those of
    the reference's ``external.sort_file``; the 0-valued knobs
    (``n_partitions``, ``flush_bytes``, ``batch_segments``) mean
    *auto-tuned by the planner*.  ``device`` is where the Sort stage
    runs: ``"cuda"`` (the default; raises without a GPU) or ``"cpu"``."""

    memory_budget_bytes: int = 256 << 20
    batch_records: int = 500_000
    n_partitions: int = 0
    sample_frac: float = 0.01
    n_leaf: int = 0
    workdir: "str | None" = None
    use_kernels: bool = False
    device_sort: bool = False
    n_readers: int = 1
    n_sorters: int = 1
    n_writers: int = 0
    manifest: bool = False
    fmt: "object | None" = None
    flush_bytes: int = 0
    model: "object | None" = None
    executor: str = "auto"
    partitioner: str = "auto"
    batch_segments: int = 0
    model_cache: "object | None" = None
    device: str = "cuda"

    def replace(self, **overrides) -> "SortConfig":
        return dataclasses.replace(self, **overrides)

    def to_pipeline(self):
        """The internal ``SortPipelineConfig`` this config compiles to."""
        from repro_torch.core.pipeline import SortPipelineConfig

        return SortPipelineConfig.from_sort_config(self)


_SORT_FIELDS = frozenset(f.name for f in dataclasses.fields(SortConfig))
_warned_legacy_kwargs = False


def coerce_sort_config(config, overrides: dict, *, warn=True) -> SortConfig:
    """The single legacy-keyword shim behind ``external.sort_file``:
    ``config=None`` with bare keywords builds the same config but warns
    once per process; with an explicit ``config=``, keywords are
    per-call overrides."""
    global _warned_legacy_kwargs
    overrides = dict(overrides)
    overrides.pop("keep_stats", None)
    unknown = set(overrides) - _SORT_FIELDS
    if unknown:
        raise TypeError(
            f"sort_file() got unexpected keyword arguments "
            f"{sorted(unknown)} — valid SortConfig fields: "
            f"{sorted(_SORT_FIELDS)}"
        )
    if config is None:
        if overrides and warn and not _warned_legacy_kwargs:
            _warned_legacy_kwargs = True
            warnings.warn(
                "bare keyword arguments to sort_file() are deprecated; "
                "pass config=SortConfig(...) (keywords on top of an "
                "explicit config stay supported as per-call overrides)",
                DeprecationWarning,
                stacklevel=3,
            )
        config = SortConfig()
    elif not isinstance(config, SortConfig):
        raise TypeError(
            f"config must be a SortConfig, got {type(config).__name__}"
        )
    return config.replace(**overrides) if overrides else config


@dataclasses.dataclass(frozen=True)
class ExecutorConfig:
    """The sort-executor seam: which implementation runs the
    per-partition sorts, on which device, and how its super-batches are
    bounded."""

    executor: str = "auto"  # auto | host | batched
    device_sort: bool = False
    use_kernels: bool = False
    batch_slots: int = 0  # 0 -> executor default
    batch_bytes: int = 0  # 0 -> executor default
    max_segments: int = 0  # 0 -> executor default
    device: str = "cuda"

    def replace(self, **overrides) -> "ExecutorConfig":
        return dataclasses.replace(self, **overrides)
