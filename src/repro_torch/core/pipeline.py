"""Pipelined, parallel ELSAR runtime — the stage orchestrator (port of
``src/repro/core/pipeline.py``; paper §3.2 + Fig. 6; DESIGN.md §1, §10).

The runtime is six composable phase stages

    Sample -> Train -> Plan -> Partition -> Sort -> Write

connected by bounded queues.  Sample, Train, Plan, Partition and Write
run on the host exactly as in the reference; the Sort stage runs behind
the ``repro_torch.core.executor.SortExecutor`` seam on the configured
``device`` (the batched grid graph with the CUDA kernels on a card).
Output is byte-identical for any ``n_readers``, any writer width and
any executor — ties between equal keys stay in input order everywhere.

With ``emit_manifest`` the run ends by writing
``<output>.manifest.npz`` (``repro_torch.core.manifest``), the learned
index that ``repro_torch.serve`` answers queries from; an empty input
sorted under a pre-trained model gets one too, with zero counts, so it
stays aligned with its co-partitioned siblings.  Not ported yet: the
warm-start model cache (``model_cache``); asking for it raises
``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import queue
import shutil
import tempfile
import threading

import numpy as np

from repro_torch.core import manifest as manifest_lib
from repro_torch.core import planner, rmi
from repro_torch.core.executor import make_executor, resolve_device
from repro_torch.core.format import GENSORT
from repro_torch.core.stages import (
    PartitionSpill,
    PhaseClock,
    SortStats,
    SpillBudget,
    WriterPool,
    loader_worker,
    reader_worker,
    sorter_worker,
    spill_root,
)


def _resolve_fmt(fmt):
    """Public-config formats may be named by string: ``"line"`` (default
    key window), ``"gensort"``/``"fixed"`` (the 100/10 layout).  Format
    objects and None (sniff/gensort default) pass through."""
    if not isinstance(fmt, str):
        return fmt
    from repro_torch.core.format import LineFormat

    name = fmt.lower()
    if name == "line":
        return LineFormat()
    if name in ("gensort", "fixed"):
        return GENSORT
    raise ValueError(
        f"unknown record format name {fmt!r}: use 'line', 'gensort', "
        f"or pass a format object from repro_torch.core.format"
    )

__all__ = [
    "PartitionSpill",
    "PhaseClock",
    "SortPipelineConfig",
    "SortStats",
    "run_pipeline",
]


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SortPipelineConfig:
    """Knobs for the pipelined runtime (defaults = historical behavior)."""

    n_readers: int = 1  # r in paper §3.2
    n_sorters: int = 1
    n_writers: int = 0  # positioned-write pool width; 0 -> auto-tuned
    memory_budget_bytes: int = 256 << 20
    batch_records: int = 500_000
    n_partitions: int = 0  # 0 -> auto-tuned from budget + sample
    sample_frac: float = 0.01
    n_leaf: int = 0  # 0 -> sized from the sample
    workdir: str | None = None
    use_kernels: bool = False
    device_sort: bool = False
    stripes_per_reader: int = 4  # work-stealing granularity
    flush_bytes: int = 0  # spill threshold per fragment; 0 -> auto-tuned
    queue_depth: int = 2  # bound on each inter-stage queue
    # emit <output>.manifest.npz for query serving (repro_torch.serve)
    emit_manifest: bool = False
    # record layout (core/format.py); None -> the gensort 100/10 layout
    fmt: "object | None" = None
    # pre-trained CDF model (repro_torch.core.rmi.RMIParams); None ->
    # sample + train.  Sorting N inputs under ONE shared model makes
    # their outputs co-partitioned (aligned equi-depth partitions).
    model: "rmi.RMIParams | None" = None
    # sort-executor selection (core/executor.make_executor): auto ->
    # batched on a CUDA device; on the CPU host unless
    # device_sort/use_kernels, then batched; host | batched force one.
    executor: str = "auto"
    # pre-sort planner (core/planner.py, DESIGN.md §11): "auto" lets the
    # sample diagnostics pick between the learned-model partitioner and
    # the sample-splitter fallback; "model" | "splitter" force a path.
    # Inert when ``model`` is pre-trained (co-partitioning must not
    # diverge from the shared model's buckets).
    partitioner: str = "auto"
    # batched-executor super-batch segment cap; 0 -> auto-tuned
    batch_segments: int = 0
    # warm-start model cache: not ported yet (must stay None)
    model_cache: "object | None" = None
    # where the Sort stage runs: "cuda" (raises without a GPU) or "cpu"
    device: str = "cuda"

    @classmethod
    def from_sort_config(cls, cfg) -> "SortPipelineConfig":
        """Compile the public ``repro_torch.core.config.SortConfig`` into this
        internal runtime config (the only place the two are mapped)."""
        return cls(
            n_readers=cfg.n_readers,
            n_sorters=cfg.n_sorters,
            n_writers=cfg.n_writers,
            memory_budget_bytes=cfg.memory_budget_bytes,
            batch_records=cfg.batch_records,
            n_partitions=cfg.n_partitions,
            sample_frac=cfg.sample_frac,
            n_leaf=cfg.n_leaf,
            workdir=cfg.workdir,
            use_kernels=cfg.use_kernels,
            # kernels imply the device path, as the legacy kwargs did
            device_sort=cfg.device_sort or cfg.use_kernels,
            emit_manifest=cfg.manifest,
            fmt=_resolve_fmt(cfg.fmt),
            flush_bytes=cfg.flush_bytes,
            model=cfg.model,
            executor=cfg.executor,
            partitioner=cfg.partitioner,
            batch_segments=cfg.batch_segments,
            model_cache=cfg.model_cache,
            device=cfg.device,
        )


# ---------------------------------------------------------------------------
# Train stage
# ---------------------------------------------------------------------------


def _train_stage(sample: np.ndarray, n_leaf: int) -> rmi.RMIParams:
    if n_leaf == 0:
        # plenty of leaves (production RMIs use 1e4-1e6): a skew spike
        # must get its own leaf for the local-frame precision to engage
        n_leaf = int(min(65536, max(1024, sample.shape[0] // 4)))
    return rmi.fit(sample, n_leaf=n_leaf)


# ---------------------------------------------------------------------------
# Orchestrator
# ---------------------------------------------------------------------------


def run_pipeline(
    input_path: str, output_path: str, cfg: SortPipelineConfig
) -> SortStats:
    """Sort ``input_path`` into ``output_path`` with the pipelined runtime."""
    if cfg.n_readers < 1 or cfg.n_sorters < 1:
        raise ValueError(
            f"n_readers and n_sorters must be >= 1, got "
            f"{cfg.n_readers}/{cfg.n_sorters}"
        )
    if cfg.n_writers < 0:
        raise ValueError(
            f"n_writers must be >= 0 (0 = auto), got {cfg.n_writers}"
        )
    if cfg.model_cache is not None:
        raise NotImplementedError("the model cache is not ported yet")
    device = resolve_device(cfg.device)
    fmt = cfg.fmt if cfg.fmt is not None else GENSORT
    stats = SortStats()
    clock = PhaseClock()
    stats.n_readers = cfg.n_readers
    file_bytes = os.path.getsize(input_path)
    stats.input_bytes = file_bytes
    # output size is format-defined (fixed: identical; lines: +1 when the
    # final line needs its normalization delimiter).  Raises early on a
    # malformed fixed file (size not a record multiple).
    out_bytes = fmt.output_bytes(input_path)
    if fmt.kind == "fixed":
        n_est = file_bytes // fmt.record_bytes
    else:
        n_est = fmt.estimate_n_records(input_path)
    stats.n_records = n_est  # exact count lands after the partition phase

    # budget-only partition sizing (one partition fits comfortably in the
    # budget) — used by the empty-output early path and as the planner's
    # starting point; the planner may clamp it by sample cardinality
    n_partitions = cfg.n_partitions
    if n_partitions == 0:
        part_bytes_target = max(cfg.memory_budget_bytes // 4, 1 << 20)
        n_partitions = max(1, int(np.ceil(file_bytes / part_bytes_target)))

    if out_bytes == 0:  # nothing to sort; still produce the (empty) output
        with clock.timer("setup"):
            open(output_path, "wb").close()
        # a shared-model sort must stay co-partition-aligned even when
        # empty: emit the manifest with n_partitions zero counts.  Without
        # a pre-trained model there is nothing to index — no manifest.
        if cfg.emit_manifest and cfg.model is not None:
            stats.partition_counts = [0] * n_partitions
            _emit_manifest(clock, stats, cfg.model, output_path, fmt)
        clock.finish(stats)
        return stats

    # (Alg. 1 line 1 — output preallocation — now lives inside the
    # WriterPool below: posix_fallocate on the pool's shared fd, §15)

    # --- Sample + Train stages (Alg. 1 line 2); a pre-trained shared
    # model (co-partitioned multi-input sorts) skips both
    if cfg.model is not None:
        model = cfg.model
        # co-partitioned sorts must route through the shared model with
        # the caller's n_partitions — the planner only tunes spill/batch
        plan = planner.preplanned(
            model,
            n_partitions=n_partitions,
            file_bytes=file_bytes,
            memory_budget_bytes=cfg.memory_budget_bytes,
            n_readers=cfg.n_readers,
            explicit_flush=cfg.flush_bytes,
            explicit_segments=cfg.batch_segments,
            explicit_writers=cfg.n_writers,
        )
    else:
        with clock.timer("train"):
            sample = fmt.sample_keys(input_path, n_est, cfg.sample_frac)
            clock.add_io(read=sample.shape[0] * fmt.key_width)
            model = _train_stage(sample, cfg.n_leaf)
        # --- Plan stage (DESIGN.md §11): diagnose the sample, pick the
        # partitioner (learned model vs sample splitter), tune the knobs
        with clock.timer("plan"):
            plan = planner.plan_sort(
                sample,
                model,
                file_bytes=file_bytes,
                memory_budget_bytes=cfg.memory_budget_bytes,
                n_readers=cfg.n_readers,
                explicit_partitions=cfg.n_partitions,
                explicit_flush=cfg.flush_bytes,
                explicit_segments=cfg.batch_segments,
                explicit_writers=cfg.n_writers,
                planner_cfg=planner.PlannerConfig(
                    partitioner=cfg.partitioner
                ),
            )
    n_partitions = plan.knobs.n_partitions
    stats.planner_decision = plan.decision
    stats.planner_reason = plan.reason
    stats.planner_diagnostics = plan.diagnostics.as_dict()
    stats.tuned_knobs = plan.knobs.as_dict()
    # workers see the effective (tuned or caller-pinned) knob values
    cfg = dataclasses.replace(
        cfg,
        n_partitions=n_partitions,
        flush_bytes=plan.knobs.flush_bytes,
        batch_segments=plan.knobs.batch_segments,
        n_writers=plan.knobs.n_writers,
    )

    # --- Sort executor (the pluggable seam, DESIGN.md §10).  Batch
    # bounds derive from the memory budget so in-flight super-batches
    # stay within a small multiple of it.
    from repro_torch.core.config import ExecutorConfig

    executor = make_executor(
        model,
        ExecutorConfig(
            executor=cfg.executor,
            device_sort=cfg.device_sort,
            use_kernels=cfg.use_kernels,
            batch_bytes=cfg.memory_budget_bytes,
            max_segments=cfg.batch_segments,
            device=str(device),
        ),
        clock=clock,
    )
    stats.executor = executor.name
    # a batching executor needs a single sorter that owns the super-batch
    n_sorters = cfg.n_sorters if executor.parallel_safe else 1

    # --- Partition / Sort / Write stages, queue-connected.  Spills are
    # RAM-first under a shared budget (half the memory budget, §12):
    # fragments that fit wait in memory, the overflow hits disk exactly
    # as before — content and order are placement-independent.
    tmp = tempfile.mkdtemp(prefix="elsar_", dir=spill_root(cfg.workdir))
    spill_ram = SpillBudget(cfg.memory_budget_bytes // 2)
    spills = [
        PartitionSpill(os.path.join(tmp, f"p{j:05d}.bin"), ram=spill_ram)
        for j in range(n_partitions)
    ]
    stripe_q: queue.SimpleQueue = queue.SimpleQueue()
    for stripe in fmt.file_stripes(
        input_path, cfg.n_readers * cfg.stripes_per_reader
    ):
        stripe_q.put(stripe)
    sort_q: queue.Queue = queue.Queue(maxsize=cfg.queue_depth)
    write_q: queue.Queue = queue.Queue(maxsize=cfg.queue_depth)
    partition_done = threading.Event()
    abort = threading.Event()
    offsets_box: dict = {}
    errors: list = []

    readers = [
        threading.Thread(
            target=reader_worker,
            args=(clock, plan.partitioner, fmt, spills, stripe_q,
                  input_path, cfg, abort, errors),
            name=f"elsar-reader-{i}",
            daemon=True,
        )
        for i in range(cfg.n_readers)
    ]
    loader = threading.Thread(
        target=loader_worker,
        args=(clock, fmt, spills, offsets_box, partition_done, sort_q, cfg,
              n_sorters, abort, errors),
        name="elsar-loader",
        daemon=True,
    )
    sorters = [
        threading.Thread(
            target=sorter_worker,
            args=(executor, sort_q, write_q, abort, errors),
            name=f"elsar-sorter-{i}",
            daemon=True,
        )
        for i in range(n_sorters)
    ]
    # the WriterPool owns output creation + preallocation (Alg. 1
    # line 1: posix_fallocate on the shared fd, truncate fallback) and
    # runs cfg.n_writers positioned pwrite workers (DESIGN.md §15)
    with clock.timer("setup"):
        pool = WriterPool(
            clock, output_path, write_q, n_sorters, abort, errors,
            n_writers=cfg.n_writers or 1, out_bytes=out_bytes,
        )

    for t in [loader, *sorters, *readers]:
        t.start()
    pool.start()
    for t in readers:
        t.join()
    for spill in spills:
        spill.close_writer()
    counts = [spill.n_records for spill in spills]
    sizes = [spill.n_bytes for spill in spills]
    stats.partition_counts = counts
    stats.n_records = sum(counts)
    # write offsets are byte-exact prefix sums of the spill sizes (for a
    # fixed layout this is counts * record_bytes, as before)
    offsets_box["offsets"] = np.concatenate(
        [[0], np.cumsum(sizes, dtype=np.int64)[:-1]]
    ).astype(np.int64)
    if not abort.is_set() and sum(sizes) != out_bytes:
        abort.set()
        errors.append(
            RuntimeError(
                f"partitioned {sum(sizes)} bytes but expected {out_bytes} "
                f"— record-boundary split bug (format {fmt.kind!r})"
            )
        )
    partition_done.set()
    for t in [loader, *sorters]:
        t.join()
    pool.join()
    stats.n_writers = pool.n_writers
    stats.writer_bytes = list(pool.writer_bytes)
    stats.writer_stall_seconds = list(pool.writer_stall_seconds)

    if errors:
        # a failed sort leaves nothing behind: undrained spill fragments
        # and the partial (preallocated) output go before the error
        # surfaces, so callers never mistake a partial file for sorted
        shutil.rmtree(tmp, ignore_errors=True)
        with contextlib.suppress(OSError):
            os.unlink(output_path)
        raise errors[0]
    os.rmdir(tmp)
    stats.fallbacks += executor.fallbacks
    stats.spill_disk_bytes = spill_ram.disk_bytes

    if cfg.emit_manifest:
        _emit_manifest(clock, stats, model, output_path, fmt)
    clock.finish(stats)
    return stats


def _emit_manifest(clock, stats, model, output_path, fmt) -> None:
    """Write ``<output>.manifest.npz`` under the ``manifest`` phase."""
    with clock.timer("manifest"):
        m = manifest_lib.build(
            model, stats.partition_counts, output_path, fmt=fmt
        )
        mpath = manifest_lib.manifest_path(output_path)
        manifest_lib.save(m, mpath)
        stats.manifest_path = mpath
