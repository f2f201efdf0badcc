"""Streaming mesh-scale external sort — the paper's stated future work
(§8) — over the ranks of a data mesh (port of
``src/repro/core/terasort.py``):

  host file  --chunks-->  mesh all-to-all partition  --spill-->  per-range
  host runs  --LearnedSort per range-->  concatenate = sorted file

Every record is routed ONCE to the rank that owns its global equi-depth
key range (one collective per chunk), and the range spills of different
chunks need no merge: each range is sorted once, at the end.  Only row
*indices* cross the wire; a rank gathers the bytes of the rows it
receives from its own mmap of the input into its range spill.

The reference is one process driving every device; here every rank of
the mesh (``launch/mesh.DataMesh``) calls :func:`sort_file_distributed`
with the same arguments:

* every rank trains the same model from the same striped sample (NumPy
  float64, deterministic) and checks with one all-gather that the model
  hashes agree;
* chunk ``c`` splits into ``world_size`` contiguous stripes; rank ``r``
  encodes stripe ``r`` and routes it with the RMI kernel;
* rank ``r`` owns key range ``r``: it spills the range, sorts it once
  through ``make_executor``, and ``pwrite``s it at its offset (from the
  all-gathered range sizes) in the shared output file, which rank 0
  creates and preallocates;
* the counts of the sort (``partition_counts``, fallbacks, bytes,
  executor dispatches, the manifest rank 0 builds) come from
  all-gathered counts, so every rank returns the same ones.  Phase
  seconds and the writer pool's lists are the rank's own.

The capacity-doubling retry decides on ``lost`` summed over every rank,
so the ranks retry together.  Byte identity with ``external.sort_file``
holds for ties too: each received fragment is spilled in ascending input
order and the final per-range sort is stable.  A process with no
process group is a 1-device mesh.
"""

from __future__ import annotations

import contextlib
import os
import queue
import shutil
import tempfile
import threading

import numpy as np
import torch

from repro_torch.core import distributed, encoding, partition, rmi
from repro_torch.core import manifest as manifest_lib
from repro_torch.core.executor import make_executor
from repro_torch.core.format import GENSORT, RecordFormat
from repro_torch.core.stages.queues import Abort, put
from repro_torch.core.stages.reader import spill_root
from repro_torch.core.stages.stats import PhaseClock, SortStats
from repro_torch.core.stages.writer import WriterPool

# executor counters, summed over the ranks unless the executor counts
# its collective dispatches on every rank alike
_COUNTERS = ("device_dispatches", "batch_slots", "batch_records", "jit_compiles")


def sort_file_distributed(
    input_path: str,
    output_path: str,
    mesh,
    axis_names=("data",),
    *,
    fmt: RecordFormat = GENSORT,
    chunk_records: int = 1 << 18,
    sample_frac: float = 0.01,
    capacity_factor: float = 1.6,
    workdir: "str | None" = None,
    device_sort: bool = False,
    use_kernels: bool = False,
    executor: str = "auto",
    manifest: bool = False,
    n_writers: int = 0,
) -> SortStats:
    """Sort a record file using the mesh as the partitioning engine.

    ``executor`` selects each rank's range sorter through the shared
    ``SortExecutor`` seam, on the mesh's device (``"auto"`` resolves as
    ``make_executor`` does there; ``"mesh"`` sorts every rank's range in
    one collective group dispatch).  Range spills land under
    ``spill_root(workdir, per_host=True)``, a directory of the rank's
    own.  The final pass drains through a :class:`WriterPool` on each
    rank (``n_writers=0`` sizes it from the mesh size).  On any failure
    the rank's spill state goes and a partial output file is removed.
    """
    mesh.check_axes(axis_names)
    stats = SortStats()
    clock = PhaseClock()
    n_dev = mesh.world_size
    rank = mesh.rank
    src = fmt.read_block(input_path)
    n = src.n_records
    stats.n_records = n
    stats.input_bytes = src.n_bytes
    if n == 0:
        if rank == 0:
            open(output_path, "wb").close()
        mesh.barrier()
        clock.finish(stats)
        return stats

    # --- train the CDF model on a striped sample (global key ranges)
    with clock.timer("train"):
        take = max(int(n * sample_frac), 4096)
        idx = np.linspace(0, n - 1, min(take, n)).astype(np.int64)
        model = rmi.fit(np.ascontiguousarray(src.keys[idx]))
        stats.bytes_read += int(idx.shape[0] * src.keys.shape[1])
    _check_same_model(mesh, model)

    # --- chunk loop: the mesh partitions each chunk to its owner ranks.
    # A chunk is a multiple of n_dev**2 records, so every rank's stripe
    # (chunk_records // n_dev rows, the route's n_per_device) splits
    # evenly in the block transpose; the reference rounds to n_dev and
    # its transpose fails unless the stripe is such a multiple too.
    step = n_dev * n_dev
    chunk_records = max(chunk_records // step, 1) * step
    sroot = spill_root(workdir, per_host=True)
    tmp = tempfile.mkdtemp(prefix="terasort_", dir=sroot)
    range_path = os.path.join(tmp, f"r{rank:05d}.bin")
    range_file = None
    created_output = False
    ok = False
    try:
        range_file = open(range_path, "wb", buffering=1 << 20)
        range_count = range_bytes = 0

        route_fns = {}  # capacity_factor -> route fn (lazily built)

        def route(hi, lo, val, factor):
            if factor not in route_fns:
                route_fns[factor] = _make_route_fn(
                    mesh, model, chunk_records // n_dev, factor
                )
            return route_fns[factor](hi, lo, val)

        with clock.timer("partition"):
            for off in range(0, n, chunk_records):
                cb = src.slice_records(off, min(off + chunk_records, n))
                stats.bytes_read += cb.n_bytes
                args = _stripe(cb, rank, n_dev, mesh.device)
                # graceful degradation: rare pathological chunks re-run
                # with a doubled capacity, on every rank together
                factor = capacity_factor
                for _ in range(6):
                    out_val, n_valid, lost = route(*args, factor)
                    if int(mesh.all_gather_ints([int(lost[0])]).sum()) == 0:
                        break
                    stats.fallbacks += 1
                    factor *= 2.0
                else:
                    raise RuntimeError("capacity overflow persisted at 32x")
                # spill the received rows in ascending input order (equal
                # keys share a bucket, so input order within a range is
                # input order globally)
                rows = np.sort(out_val[: int(n_valid[0])].cpu().numpy())
                if rows.size == 0:
                    continue
                payload = cb.gather_bytes(rows)
                range_file.write(payload)
                range_count += int(rows.size)
                range_bytes += len(payload)
        range_file.close()

        # --- final pass: each rank sorts its range once and writes it
        # at its offset; the ranges are disjoint, so any order is safe
        sizes = mesh.all_gather_ints([range_count, range_bytes])
        stats.partition_counts = sizes[:, 0].tolist()
        offsets = np.concatenate([[0], np.cumsum(sizes[:, 1])[:-1]])
        out_bytes = int(sizes[:, 1].sum())

        ex = make_executor(
            model,
            device_sort=device_sort,
            use_kernels=use_kernels,
            executor=executor,
            mesh=mesh,
            device=mesh.device,
            clock=clock,
        )
        stats.executor = ex.name
        sort_read = 0

        def ranges():
            nonlocal sort_read
            if range_count == 0:
                os.unlink(range_path)
                return
            with clock.timer("sort_read"):
                blob = np.fromfile(range_path, dtype=np.uint8)
                sort_read += blob.nbytes
                os.unlink(range_path)
            # parse_blob only needs the buffer protocol — no copy
            yield int(offsets[rank]), fmt.parse_blob(blob)

        write_q: queue.Queue = queue.Queue(maxsize=4)
        abort = threading.Event()
        werrors: list = []

        def writer_pool(create: bool) -> WriterPool:
            return WriterPool(
                clock, output_path, write_q, 1, abort, werrors,
                n_writers=n_writers or max(1, min(4, n_dev)),
                out_bytes=out_bytes, create=create,
            )

        # rank 0 creates and preallocates the output; the others open it
        # once it exists
        pool = writer_pool(True) if rank == 0 else None
        created_output = rank == 0
        mesh.barrier()
        if pool is None:
            pool = writer_pool(False)
            created_output = True
        pool.start()
        try:
            for at, block in ex.sort_iter(ranges()):
                put(write_q, (int(at), block), abort)
            put(write_q, None, abort)
        except Abort:
            pass  # a writer failed; its error re-raises below
        except BaseException:
            abort.set()  # release writers blocked on the queue
            raise
        finally:
            pool.join()
        if werrors:
            raise werrors[0]
        stats.n_writers = pool.n_writers
        stats.writer_bytes = list(pool.writer_bytes)
        stats.writer_stall_seconds = list(pool.writer_stall_seconds)

        # --- the sort's counts over every rank (also the barrier after
        # which the whole output is written)
        counters = [clock.counters.get(k, 0) for k in _COUNTERS]
        tot = mesh.all_gather_ints(
            [range_bytes, sort_read, clock.bytes_read, clock.bytes_written,
             ex.fallbacks, *counters]
        )
        total = tot.sum(0)
        stats.bytes_written += int(total[0])
        stats.bytes_read += int(total[1])
        clock.bytes_read, clock.bytes_written = int(total[2]), int(total[3])
        stats.fallbacks += int(total[4])
        counted = tot[0] if ex.collective else total
        clock.counters.update(zip(_COUNTERS, (int(c) for c in counted[5:])))

        if manifest:
            mp = manifest_lib.manifest_path(output_path)
            if rank == 0:
                with clock.timer("manifest"):
                    m3 = manifest_lib.build(
                        model, stats.partition_counts, output_path, fmt=fmt
                    )
                    manifest_lib.save(m3, mp)
            mesh.barrier()
            stats.manifest_path = mp
        ok = True
    finally:
        # no resource outlives a failure: the spill file and dir go
        # unconditionally (the writer pool closes its own fd in join),
        # and a partial output file is removed rather than left looking
        # sorted
        if range_file is not None and not range_file.closed:
            range_file.close()
        shutil.rmtree(tmp, ignore_errors=True)
        if sroot is not None:
            # the host<k> subdir spill_root created is ours too; rmdir
            # only succeeds when empty, so concurrent runs keep theirs
            with contextlib.suppress(OSError):
                os.rmdir(sroot)
        if not ok and created_output:
            with contextlib.suppress(OSError):
                os.unlink(output_path)
    clock.finish(stats)
    return stats


def _check_same_model(mesh, model: rmi.RMIParams) -> None:
    """Every rank trained its own model; they must be one model."""
    word = int(manifest_lib.model_hash(model)[:15], 16)
    words = mesh.all_gather_ints([word])[:, 0]
    if (words != word).any():
        raise RuntimeError(
            f"ranks trained different models (hash prefixes {words.tolist()})"
        )


def _stripe(cb, rank: int, n_dev: int, device) -> tuple[torch.Tensor, ...]:
    """Rank ``rank``'s stripe of chunk ``cb`` as ``(hi, lo, val)`` on
    ``device``: rows ``[rank * w, (rank + 1) * w)`` of the chunk, ``val``
    their row indices, with ``w`` the chunk's records over ``n_dev``
    rounded up to a multiple of ``n_dev`` (so the router's block
    transpose splits every stripe evenly).  Rows past the chunk's end are
    padding: SENTINEL words and ``val = -1``, which the router discards
    by its ``val``, so a real key of SENTINEL words is still sent."""
    m = cb.n_records
    w = -(-m // (n_dev * n_dev)) * n_dev
    start = rank * w
    k = max(min(w, m - start), 0)
    words = np.full((2, w), encoding.SENTINEL, dtype=np.int64)
    if k:
        words[0, :k], words[1, :k] = encoding.encode_np(cb.keys[start : start + k])
    val = np.full(w, -1, dtype=np.int32)
    val[:k] = np.arange(start, start + k, dtype=np.int32)
    words_d = torch.from_numpy(words).to(device)
    return words_d[0], words_d[1], torch.from_numpy(val).to(device)


def _make_route_fn(mesh, model, n_per_device, capacity_factor):
    """Route-only variant of ``distributed.make_sort_fn`` (no sort —
    ranges are spilled and sorted once at the end).  Only row indices
    (``val``) cross the wire; keys bucket locally and are dropped.
    Returns ``fn(hi, lo, val) -> (val_routed, n_valid, lost)`` over the
    rank's stripe: ``val_routed`` the rank's received row indices,
    compacted to the front in arrival order, ``n_valid`` their count and
    ``lost`` the rows this rank could not send (shape ``(1,)`` each)."""
    n_dev = mesh.world_size
    capacity = partition.route_capacity(n_per_device, n_dev, capacity_factor)
    model = model.to(mesh.device)

    def fn(hi, lo, val):
        hi, lo, val = distributed.transpose_shuffle(mesh, n_dev, hi, lo, val)
        # padding rows (val < 0, a short final chunk's) must not consume
        # real bucket capacity: they go to the discard bucket
        g, valid, lost = distributed.route(
            mesh, model, hi, lo, capacity, discard=val < 0
        )
        send_val = torch.where(valid, val[g], -1)
        recv_val = mesh.all_to_all(send_val).reshape(-1)
        n_valid = (recv_val >= 0).sum().to(torch.int32)
        # compact valid records to the front (stable by arrival)
        order = torch.sort((recv_val < 0).to(torch.int8), stable=True).indices
        return recv_val[order], n_valid[None], lost

    return fn
