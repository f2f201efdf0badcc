"""The full-key driver: gensort keys ordered on the card by their whole
key, as valsort checks it, through the program's device entry point.

Set-up, window and check follow ``harness.run_cell``, whose pieces this
uses (the schedule, the pool and the model, the result line); what
differs is the timed path and the answer it keeps.  A call is
``kernels.ops.encode_full_keys`` on the pool's HBM-resident ``(n,
key_bytes)`` slice, read at its own stride, then
``core.learned_sort.sort_device(model, hi, lo, tail=tail,
return_overflow=True)``, ending in ``torch.cuda.synchronize()``.  The
answer is ``(hi, lo, tail, perm)``.  The calls the seed picked, the
first call down each of ``sort_device``'s two paths and the window's
last call are kept and, after the window, checked against the raw key
bytes by :mod:`full_key_reference` in blocks of 2^24 rows: ``perm_bad``,
``words_bad`` (all three words), ``order_bad`` (10-byte memcmp) and
``ties_bad`` (equal keys out of input order), limit 0 each.  Slots for
the kept answers are allocated before the window only for the seed's
calls and the paths the warm-up took; a path first taken in the window
gets its slot there.

The line reports ``sort_Mrec_s``, ``peak_GiB`` and ``setup_s``.  Traced
runs also attribute the window's device seconds to the program's
innermost span (``spans.by_span``), for ``full_key_ms``; the trace's
time of the full-key encode kernel gives ``encode_full_roofline`` (its
least bytes counted by :mod:`full_key_roofline`); the HBM cells' readers of the layers this
cell shares with them (``fallback_pct``, ``fallback_records_pct``,
``torch_ops_ms``, ``rmi_roofline``, ``device_idle_pct``) read its
``Context`` unchanged.  A program without ``ops.encode_full_keys``
fails at the first step, before any data is made.

``PATHS`` and :func:`sort_for` are the controls and planted faults that
``control.py`` puts in the program's place: ``prefix8`` (the program's
8-byte sort, the tails carried along unordered), ``f64`` (the reference
on the first 8 bytes rounded to a float64), and swaps planted in the
tail's pass (``tail``: its first two records), in the row sorter
(``rows``: the first records of two rows) and in the stable fallback
(``fallback``: its first record and the first of another 8-byte key).
A swap inside one run of equal 8-byte keys would be put right by the
tail's pass, so the path faults swap across runs.
"""

from __future__ import annotations

import dataclasses
import time

import torch
from torch.profiler import record_function

from perfbench import (full_key_reference, gensort_keys, harness, manifest, spans, stats,
                       trace, traffic)

CONTROLS = ("prefix8", "f64")
FAULTS = ("tail", "rows", "fallback")
PATHS = (*CONTROLS, *FAULTS)


@dataclasses.dataclass
class FullKeyContext(harness.Context):
    # traced runs: device seconds of the window by innermost program span
    span_device_s: dict = dataclasses.field(default_factory=dict)


def program_sort():
    """The timed path: ``sort(model, keys) -> (hi, lo, tail, perm,
    overflow)``.  A program without the full-key entry points fails
    here, before any data is made."""
    from repro_torch.core import learned_sort
    from repro_torch.kernels import ops

    encode = ops.encode_full_keys

    def sort(model, keys):
        with record_function("perfbench.encode_full_keys"):
            hi, lo, tail = encode(keys)
        with record_function("perfbench.sort_device"):
            return learned_sort.sort_device(model, hi, lo, tail=tail, return_overflow=True)

    return sort


def _prefix8(model, keys):
    from repro_torch.core import learned_sort
    from repro_torch.kernels import ops

    hi, lo, tail = ops.encode_full_keys(keys)
    hi_s, lo_s, perm, overflow = learned_sort.sort_device(model, hi, lo, return_overflow=True)
    return hi_s, lo_s, tail[perm.to(torch.int64)], perm, overflow


def _f64(model, keys):
    return (*full_key_reference.stable_sort(keys, "f64"), False)


def _swap(ts, i, j, row=None):
    """Copies of ``ts`` with elements ``i`` and ``j`` swapped (of column
    0 of rows ``i`` and ``j`` where ``row`` is given)."""
    out = []
    for t in ts:
        t = t.clone()
        if row is None:
            t[[i, j]] = t[[j, i]]
        else:
            t[[i, j], 0] = t[[j, i], 0]
        out.append(t)
    return tuple(out)


def _across_rows(out):
    """The row sorter's answer ``(hi, lo, val)`` with the first records of
    its first two rows that hold any exchanged: two keys of different
    buckets, so different keys that the tie pass never reorders."""
    val = out[2]
    rows = torch.nonzero(val[:, 0] < val.max()).flatten()
    return _swap(out, int(rows[0]), int(rows[1]), row=True)


def _across_runs(out):
    """The fallback's answer ``(hi, lo, perm)`` with its first record
    exchanged with the first one of another 8-byte key."""
    hi, lo = out[0], out[1]
    j = int(torch.nonzero((hi != hi[0]) | (lo != lo[0])).flatten()[0])
    return _swap(out, 0, j)


# the program's function each fault is planted in, and the fault: every
# one moves a record where the answer cannot put it back
_FAULTS = {
    "tail": ("core.learned_sort", ("order_ties",), lambda out: _swap(out, 0, 1)),
    "rows": ("kernels.bitonic", ("sort_rows_cuda", "sort_rows_plain"), _across_rows),
    "fallback": ("core.learned_sort", ("sort_oracle",), _across_runs),
}


def _planted(kind: str, program):
    """``program`` with the fault ``kind`` planted in the program's own
    module for the length of each call."""
    import importlib

    path, names, fault = _FAULTS[kind]
    mod = importlib.import_module("repro_torch." + path)

    def sort(model, keys):
        real = {name: getattr(mod, name) for name in names}
        for name, f in real.items():
            setattr(mod, name, lambda *a, f=f: fault(f(*a)))
        try:
            return program(model, keys)
        finally:
            for name, f in real.items():
                setattr(mod, name, f)

    return sort


def sort_for(name: str):
    if name == "prefix8":
        return _prefix8
    if name == "f64":
        return _f64
    if name in _FAULTS:
        return _planted(name, program_sort())
    raise ValueError(f"unknown path {name!r}")


def run(cell: manifest.Cell, seed: int, seconds: float, traced: bool, *,
        device: str, t_start: float, sort=None) -> dict:
    """One run; returns the result line as a dict.  ``sort`` replaces the
    timed path (the controls and the planted faults)."""
    from repro_torch.kernels import build, ops

    log = harness.log
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if sort is None:
        sort = program_sort()
    cfg = cell.config
    sched = traffic.Schedule(cell.traffic, seed)
    max_n = max(sched.sizes)
    if max_n > cfg["records_per_call_max"]:
        raise ValueError(f"{max_n} records a call over the configuration's cap")

    t = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(sched.device_seed)
    pool = gensort_keys.random_records(sched.pool_records, cfg, gen, dev)
    sync()
    log(f"setup: pool of {sched.pool_records} records in {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    model, digest = harness.train_model(cfg, dev)
    if cuda:
        torch.cuda.empty_cache()
    log(f"setup: model ({cfg['n_leaf']} leaves, leaf table sha256 {digest}) "
        f"trained in {time.perf_counter() - t:.3f} s")

    def slot():
        return (*(torch.empty(max_n, dtype=torch.int64, device=dev) for _ in range(3)),
                torch.empty(max_n, dtype=torch.int32, device=dev))

    t = time.perf_counter()
    warm_paths = set()
    for n in sorted(set(sched.sizes)):
        out = sort(model, pool[:n])
        sync()
        warm_paths.add(harness.PATHS[bool(out[4])])
        del out
    # one slot for each call the seed picked and one for the first call
    # down each path the warm-up took, allocated before the window so that
    # its peak holds none of them (a path first taken in the window gets
    # its slot there); then one more call of the largest size, to cache
    # again the blocks the slots took
    slots = {key: slot() for key in [*sched.checked, *sorted(warm_paths)]}
    out = sort(model, pool[:max_n])
    sync()
    del out
    log(f"setup: {len(set(sched.sizes))} sizes warmed in {time.perf_counter() - t:.3f} s")
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
    kept: dict = {}
    first: dict = {}  # path -> the first call that took it
    out = None
    setup_s = time.perf_counter() - t_start
    with record_function(trace.WINDOW):
        t0 = time.perf_counter()
        i = 0
        while True:
            n, off = sched.call(i)
            keys = pool[off : off + n]
            out = None
            with record_function("perfbench.call"):
                c0 = time.perf_counter()
                out = sort(model, keys)
                sync()
                c1 = time.perf_counter()
            overflow = bool(out[4])
            calls.append(harness.Call(n, c1 - c0, overflow))
            path = harness.PATHS[overflow]
            if i in slots:
                dest = slots[i]
            elif path not in first:
                dest = slots.get(path) or slots.setdefault(path, slot())
            else:
                dest = None
            first.setdefault(path, i)
            if dest is not None:
                if all(x.shape[0] == n for x in out[:4]):
                    kept[i] = tuple(s[:n].copy_(x) for s, x in zip(dest, out[:4]))
                    sync()
                else:  # a planted fault's answer of the wrong length
                    kept[i] = out[:4]
            i += 1
            if c1 - t0 >= seconds:
                break
        window_s = c1 - t0
    t = time.perf_counter()
    tr = trace.stop(prof) if traced else None
    by_span = spans.by_span(prof.profiler.kineto_results.events())[0] if traced else {}
    if tr is not None:
        log(f"trace: read {len(tr.device)} device events in {time.perf_counter() - t:.3f} s; "
            f"device s by span { {k: round(v, 6) for k, v in by_span.items()} }")
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    launches = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
    kept.setdefault(len(calls) - 1, out[:4])
    del model, out

    n_calls = len(calls)
    secs = [c.seconds for c in calls]
    log(f"window: {n_calls} calls, {sum(c.n for c in calls)} records in {window_s:.6f} s; "
        f"call ms p50 {stats.percentile(secs, 50) * 1e3:.4f} "
        f"p95 {stats.percentile(secs, 95) * 1e3:.4f} max {max(secs) * 1e3:.4f}; "
        f"overflowed {sum(c.overflow for c in calls)}")
    log(f"window: kernel launches {launches} ({n_calls} calls)")
    log(f"window: peak {peak} B allocated, {base} B of it at the start; "
        f"set-up peak {setup_peak} B; pool {pool.numel()} B, answer slots "
        f"{sum(x.numel() * x.element_size() for s in slots.values() for x in s)} B; "
        f"checked calls {sorted(kept)} (first down each path: {first})")
    if tr is not None:
        log(f"trace: device busy {tr.busy_s:.6f} s of {tr.window_s:.6f} s")

    totals = dict.fromkeys(full_key_reference.LIMITS, 0)
    failed = 0
    for i in sorted(kept):
        n, off = sched.call(i)
        bad = full_key_reference.check(pool[off : off + n], *kept[i])
        log(f"check: call {i} ({n} records at {off}): {bad}")
        failed += any(bad.values())
        for k, v in bad.items():
            totals[k] += v
    del kept, slots
    ctx = FullKeyContext(
        config=cfg,
        device_name=torch.cuda.get_device_name(dev) if cuda else "cpu",
        calls=calls, window_s=window_s, setup_s=setup_s, peak_bytes=peak, base_bytes=base,
        trace=tr,
        port_kernels=trace.port_kernel_names(manifest.ROOT / "src" / "repro_torch" / "csrc"),
        span_device_s=by_span,
    )
    return harness.result_line(cell, ctx, traced, attempted=n_calls, failed=failed,
                               totals=totals, limits=full_key_reference.LIMITS,
                               memory_peak_bytes=max(peak, setup_peak))
