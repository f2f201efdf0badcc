"""The file-sort driver: ELSAR's job end to end, a gensort file sorted
file to file by ``repro_torch.core.external.sort_file`` (Sample, Train,
Plan, Partition on the host, Sort on the card, Write).

Set-up (all of it in ``setup_s``): the input, the configuration's
``file_records`` gensort ``-a`` records made on the device from the seed
(:mod:`gensort_file`), is written under the mix's ``work_dir`` and
fsynced; one untimed call sorts it (which loads the kernel library).

The window is a closed loop with one caller.  Call ``k`` is
``sort_file(input, output[k % output_slots], config=SortConfig(
**sort_config))``, then an fsync of the output and
``torch.cuda.synchronize()``, timed on the host clock; calls run until
they add up to ``--seconds``, the last one to its end.  Between calls,
with the clock stopped (a ``perfbench.pause`` span), the output slot
the next call writes is deleted.  The input is read warm, as the mix's
``page_cache`` says: on a root file system that serves reads from its
host's cache, dropping the file's pages reads no faster or slower.

After the window, the peak read and the program's state freed, the
reference (:mod:`file_reference`) checks the outputs the window's last
calls left in the slots, byte for byte; then the work directory is
removed.  Metrics are read from a :class:`FileContext`: the harness's
``Context`` and each call's ``SortStats``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
import time

import torch
from torch.profiler import record_function

from perfbench import file_controls, file_reference, gensort_file, harness, manifest, trace

PATHS = file_controls.PATHS


@dataclasses.dataclass
class FileContext(harness.Context):
    # one ``SortStats`` a call of the window (None: a control's call)
    stats: list = dataclasses.field(default_factory=list)


def program_sort():
    """The timed path: ``sort(input, output, config) -> SortStats``."""
    from repro_torch.core import external

    def sort(inp, out, config):
        return external.sort_file(inp, out, config=config)

    return sort


def sort_for(name: str):
    return file_controls.sort_for(name, program_sort())


def fsync(path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def run(cell: manifest.Cell, seed: int, seconds: float, traced: bool, *,
        device: str, t_start: float, sort=None) -> dict:
    """One run; returns the result line as a dict.  ``sort`` replaces the
    timed path (the controls and the planted faults)."""
    from repro_torch.core.config import SortConfig
    from repro_torch.kernels import build, ops

    log = harness.log
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg, mix = cell.config, cell.traffic
    n = int(cfg["file_records"])
    if [int(s) for s in mix["sizes"]] != [n]:
        raise ValueError("a file-sort call sorts the whole file: sizes must be [file_records]")
    if mix.get("loop", "closed") != "closed" or mix.get("clients", 1) != 1:
        raise ValueError("the driver runs a closed loop with 1 client")
    if mix.get("page_cache") != "warm":
        raise ValueError("the driver reads its input warm: page_cache must be 'warm'")
    work = manifest.ROOT / mix["work_dir"]
    shutil.rmtree(work, ignore_errors=True)
    (work / "spill").mkdir(parents=True)
    inp = str(work / "input.bin")
    outs = [str(work / f"output-{k}.bin") for k in range(int(mix["output_slots"]))]
    config = SortConfig(**dict(cfg["sort_config"], device=device, workdir=str(work / "spill")))

    t = time.perf_counter()
    gensort_file.write(inp, cfg, seed, dev)
    log(f"setup: {n} records ({os.path.getsize(inp)} B) written and fsynced in "
        f"{time.perf_counter() - t:.3f} s")
    if sort is None:
        sort = program_sort()
    t = time.perf_counter()
    st = sort(inp, outs[-1], config)
    fsync(outs[-1])
    sync()
    log(f"setup: warm-up call in {time.perf_counter() - t:.3f} s, writing "
        f"{os.path.getsize(outs[-1]) + (st.spill_disk_bytes if st else 0)} B")
    log(f"setup: kernel library {build.build_info.get('path')} "
        f"compiled={build.build_info.get('compiled')} "
        f"in {build.build_info.get('seconds', 0):.3f} s")
    ops.reset_launches()
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    base = torch.cuda.memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    prof = trace.start(cuda) if traced else None

    calls: list = []
    stats: list = []
    written = 0  # bytes the window's calls wrote: outputs and disk spills
    wrote: dict = {}  # slot -> the window's last call that wrote it
    setup_s = time.perf_counter() - t_start
    with record_function(trace.WINDOW):
        window_s = 0.0
        while window_s < seconds:
            k = len(calls)
            slot = k % len(outs)
            with record_function(trace.PAUSE), contextlib.suppress(FileNotFoundError):
                os.unlink(outs[slot])
            with record_function("perfbench.call"):
                c0 = time.perf_counter()
                st = sort(inp, outs[slot], config)
                c_sorted = time.perf_counter()
                fsync(outs[slot])
                sync()
                c1 = time.perf_counter()
            window_s += c1 - c0
            calls.append(harness.Call(n, c1 - c0, bool(st is not None and st.fallbacks)))
            stats.append(st)
            wrote[slot] = k
            if st is not None:
                written += os.path.getsize(outs[slot]) + st.spill_disk_bytes
                log(f"call {k}: {c1 - c0:.6f} s ({c1 - c_sorted:.6f} of it the fsync), "
                    f"{st.input_bytes / (c1 - c0) / 1e6:.3f} MB/s; "
                    f"executor {st.executor}, planner {st.planner_decision}, "
                    f"{len(st.partition_counts)} partitions, dispatches {st.device_dispatches}, "
                    f"occupancy {st.batch_occupancy:.4f}, fallbacks {st.fallbacks}, "
                    f"spilled {st.spill_disk_bytes} B; phase wall s "
                    f"{ {p: round(v, 4) for p, v in st.phase_wall_seconds.items()} }")
            else:
                log(f"call {k}: {c1 - c0:.6f} s (no SortStats)")
    t = time.perf_counter()
    tr = trace.stop(prof) if traced else None
    if tr is not None:
        log(f"trace: read {len(tr.device)} device events in {time.perf_counter() - t:.3f} s")
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    launches = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
    log(f"window: {len(calls)} calls, {n * len(calls)} records in {window_s:.6f} s "
        f"(clock stopped between calls), writing {written} B; kernel launches {launches}")
    log(f"window: peak {peak} B allocated, {base} B of it at the start; set-up peak {setup_peak} B")
    if tr is not None:
        log(f"trace: device busy {tr.busy_s:.6f} s of {tr.window_s:.6f} s")

    t = time.perf_counter()
    ref = file_reference.Reference(inp, cfg["key_bytes"], dev)
    totals = dict.fromkeys(file_reference.LIMITS, 0)
    failed = 0
    for slot, k in sorted(wrote.items(), key=lambda kv: kv[1]):
        bad = ref.check(outs[slot])
        log(f"check: call {k} ({outs[slot]}): {bad}")
        failed += any(bad.values())
        for key, v in bad.items():
            totals[key] += v
    del ref
    shutil.rmtree(work, ignore_errors=True)
    log(f"check: {len(wrote)} outputs in {time.perf_counter() - t:.3f} s")
    ctx = FileContext(
        config=cfg,
        device_name=torch.cuda.get_device_name(dev) if cuda else "cpu",
        calls=calls, window_s=window_s, setup_s=setup_s, peak_bytes=peak, base_bytes=base,
        trace=tr,
        port_kernels=trace.port_kernel_names(manifest.ROOT / "src" / "repro_torch" / "csrc"),
        stats=stats,
    )
    return harness.result_line(cell, ctx, traced, attempted=len(calls), failed=failed,
                               totals=totals, limits=file_reference.LIMITS,
                               memory_peak_bytes=max(peak, setup_peak))
