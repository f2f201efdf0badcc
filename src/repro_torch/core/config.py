"""The public configuration surface of the port (port of
``src/repro/core/config.py``; DESIGN.md §14).

* :class:`SortConfig` — one file-to-file sort, with the reference's
  fields and defaults plus ``device``: ``"cuda"`` by default, so the
  entry points run on the card unless the caller asks for ``"cpu"``.
* :class:`ExecutorConfig` — the sort-executor seam
  (``core/executor.make_executor``), with the mesh executor's ``mesh``
  and ``axis_names``.
* :class:`ServeConfig` — the query server (``serve/server.QueryServer``),
  with the reference's fields plus ``device``, where the served
  indexes predict (``"cuda"`` by default).

Bare legacy keywords to ``sort_file`` still work through
:func:`coerce_sort_config` (one ``DeprecationWarning`` per process).
The launchers (``launch/query.py``, ``launch/serve.py``,
``launch/ops.py``) build their
argument parsers from the same dataclasses with
:func:`add_sort_cli_args` / :func:`add_serve_cli_args` and read them
back with :func:`sort_config_from_args` / :func:`serve_config_from_args`.
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

    executor: str = "auto"  # auto | host | batched | per_partition | mesh
    device_sort: bool = False
    use_kernels: bool = False
    batch_slots: int = 0  # 0 -> executor default
    batch_bytes: int = 0  # 0 -> executor default
    max_segments: int = 0  # 0 -> executor default
    device: str = "cuda"
    # the mesh executor's topology: a launch.mesh.DataMesh, or None for
    # make_data_mesh() on ``device``
    mesh: "object | None" = None
    axis_names: tuple = ("data",)

    def replace(self, **overrides) -> "ExecutorConfig":
        return dataclasses.replace(self, **overrides)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Knobs of the continuous-batching query server (DESIGN.md §14).

    A batch dispatches when ``max_batch`` requests have coalesced OR the
    oldest has waited ``max_wait_ms``; submissions beyond ``queue_bound``
    are shed with a typed ``Overloaded``.  ``cache_bytes`` sizes the LRU
    partition-block cache (0 disables).  Transport: ``socket_path``
    serves a unix socket, otherwise ``host:port`` TCP (port 0 =
    ephemeral).  ``device`` is where the indexes predict positions: on
    ``"cuda"`` always through the RMI kernel; on ``"cpu"``
    ``use_kernels`` picks the kernel's plain version over the NumPy
    float64 predictor.
    """

    max_batch: int = 64
    max_wait_ms: float = 2.0
    queue_bound: int = 1024
    cache_bytes: int = 64 << 20
    use_kernels: bool = False
    host: str = "127.0.0.1"
    port: int = 0
    socket_path: "str | None" = None
    drain_timeout_s: float = 30.0
    device: str = "cuda"

    def replace(self, **overrides) -> "ServeConfig":
        return dataclasses.replace(self, **overrides)


def _add_device_arg(ap, default: str) -> None:
    """One ``--device`` flag, shared by the sort and serve knobs of a
    launcher that takes both."""
    if "--device" not in ap._option_string_actions:
        ap.add_argument("--device", default=default, choices=("cuda", "cpu"),
                        help="where the sort and the index run")


def add_sort_cli_args(ap) -> None:
    """Sort knobs shared by every launcher, derived from SortConfig
    defaults — add once, materialize with sort_config_from_args."""
    d = SortConfig()
    ap.add_argument("--budget-mb", type=int,
                    default=d.memory_budget_bytes >> 20,
                    help="memory budget for sorts (MB)")
    ap.add_argument("--readers", type=int, default=d.n_readers,
                    help="striped reader threads (paper's r)")
    ap.add_argument("--writers", type=int, default=d.n_writers,
                    help="positioned-write pool width "
                         "(0: planner auto-tunes)")
    ap.add_argument("--partitions", type=int, default=d.n_partitions,
                    help="partition count (0: planner auto-tunes)")
    ap.add_argument("--sort-executor", default=d.executor,
                    choices=("auto", "host", "batched", "per_partition",
                             "mesh"),
                    help="sort-executor seam selection")
    ap.add_argument("--partitioner", default=d.partitioner,
                    choices=("auto", "model", "splitter"),
                    help="pre-sort planner routing path")
    ap.add_argument("--workdir", default=d.workdir,
                    help="spill directory (default: a tempdir)")
    _add_device_arg(ap, d.device)


def sort_config_from_args(args, **overrides) -> SortConfig:
    """SortConfig from the add_sort_cli_args namespace (+ call-site
    overrides, e.g. fmt= or manifest=)."""
    return SortConfig(
        memory_budget_bytes=args.budget_mb << 20,
        n_readers=args.readers,
        n_writers=getattr(args, "writers", 0),
        n_partitions=args.partitions,
        executor=args.sort_executor,
        partitioner=args.partitioner,
        workdir=args.workdir,
        device=args.device,
    ).replace(**overrides)


def add_serve_cli_args(ap) -> None:
    """Server knobs, derived from ServeConfig defaults."""
    d = ServeConfig()
    ap.add_argument("--max-batch", type=int, default=d.max_batch,
                    help="coalescing window: max queries per dispatch")
    ap.add_argument("--max-wait-ms", type=float, default=d.max_wait_ms,
                    help="coalescing window: max ms the oldest waits")
    ap.add_argument("--queue-bound", type=int, default=d.queue_bound,
                    help="admission queue depth; beyond it requests shed")
    ap.add_argument("--cache-mb", type=int, default=d.cache_bytes >> 20,
                    help="LRU partition-block cache budget (0 disables)")
    ap.add_argument("--use-kernels", action="store_true",
                    help="on the CPU, predict through the RMI kernel's "
                         "plain version (a card always runs the kernel)")
    ap.add_argument("--host", default=d.host)
    ap.add_argument("--port", type=int, default=d.port,
                    help="TCP port (0: ephemeral; ignored with --socket)")
    ap.add_argument("--socket", default=d.socket_path,
                    help="serve a unix socket at this path instead of TCP")
    ap.add_argument("--drain-timeout", type=float, default=d.drain_timeout_s,
                    help="seconds to wait for in-flight work on shutdown")
    _add_device_arg(ap, d.device)


def serve_config_from_args(args, **overrides) -> ServeConfig:
    return ServeConfig(
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        queue_bound=args.queue_bound,
        cache_bytes=args.cache_mb << 20,
        use_kernels=args.use_kernels,
        host=args.host,
        port=args.port,
        socket_path=args.socket,
        drain_timeout_s=args.drain_timeout,
        device=args.device,
    ).replace(**overrides)
