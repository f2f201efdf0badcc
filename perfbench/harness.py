"""One run of one cell: set-up, the measured window, the check.

Set-up (all of it in ``setup_s``): the input pool and the RMI's training
sample are made on the device from the seed (:mod:`gensort_keys`); the
program trains its model with ``repro_torch.core.rmi.fit`` on the sample,
as its Sample and Train stages do; every size of the mix is sorted once.

The window is a closed loop with one caller.  Each call runs the timed
path, ``kernels.ops.encode_keys`` on an HBM-resident ``(n, key_bytes)``
slice of the pool and ``core.learned_sort.sort_device(model, hi, lo,
return_overflow=True)``, and ends in ``torch.cuda.synchronize()``.  The
answers of the calls the seed picked, and of the first call down each of
``sort_device``'s two paths (the row sorter and the stable fallback), are
copied aside, outside every call's time; the last call's answer is kept
as it is.  So every run checks each path that its calls took.

After the window, the peak has been read and the model freed, the
reference (:mod:`reference`) checks every kept answer against the raw
key bytes.  The metrics are read by ``perfbench/metrics/<name>.py``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import subprocess
import sys
import time

import torch
from torch.profiler import record_function

from perfbench import gensort_keys, manifest, reference, stats, trace, traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# sort_device's two paths, by its overflow flag
PATHS = ("rows", "fallback")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is
    one of :data:`FORBIDDEN`, compared whole: ``repro_torch`` is not
    ``repro``."""
    top = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(top & set(FORBIDDEN))


@dataclasses.dataclass
class Call:
    n: int
    seconds: float
    overflow: bool


@dataclasses.dataclass
class Context:
    """What a metric reader reads."""

    config: dict
    device_name: str
    calls: list
    window_s: float
    setup_s: float
    peak_bytes: int  # torch.cuda.max_memory_allocated over the window
    base_bytes: int  # torch.cuda.memory_allocated at its start: pool, slots, model
    trace: "trace.Trace | None"
    port_kernels: set


def program_sort():
    """The timed path: ``sort(model, keys) -> (hi, lo, perm, overflow)``."""
    from repro_torch.core import learned_sort
    from repro_torch.kernels import ops

    def sort(model, keys):
        with record_function("perfbench.encode_keys"):
            hi, lo = ops.encode_keys(keys)
        with record_function("perfbench.sort_device"):
            return learned_sort.sort_device(model, hi, lo, return_overflow=True)

    return sort


def train_model(cfg: dict, device):
    """The program's model, trained on the configuration's sample: the
    same records of the same file (``file_seed``) in every run, as the
    model cache serves one model for repeat sorts of one file."""
    from repro_torch.core import rmi

    gen = torch.Generator(device=device)
    gen.manual_seed(cfg["file_seed"])
    idx = gensort_keys.sample_indices(cfg, device)
    sample = gensort_keys.keys_at(idx, cfg, gen).cpu().numpy()
    model = rmi.fit(sample, n_leaf=cfg["n_leaf"])
    digest = hashlib.sha256(rmi.pack_leaf_table(model).numpy().tobytes()).hexdigest()[:16]
    return model.to(device), digest


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return out.stdout.strip() or f"not read (rc {out.returncode})"


def run_cell(
    cell: manifest.Cell,
    seed: int,
    seconds: float,
    traced: bool,
    *,
    device: str,
    t_start: float,
    sort=None,
) -> dict:
    """One run; returns the result line as a dict.  ``sort`` replaces the
    timed path (the controls and the planted faults); by default it is
    the program's."""
    from repro_torch.kernels import build, ops

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
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
    model, digest = train_model(cfg, dev)
    if cuda:
        torch.cuda.empty_cache()  # the generator's and the sample's blocks
    log(f"setup: model ({cfg['n_leaf']} leaves, leaf table sha256 {digest}) "
        f"trained in {time.perf_counter() - t:.3f} s")
    if sort is None:
        sort = program_sort()
    # where the kept answers go: one slot for each call the seed picked and
    # one for the first call down each of the two paths, allocated once,
    # so that the window's peak does not depend on which calls were kept
    slots = {
        key: (torch.empty(max_n, dtype=torch.int64, device=dev),
              torch.empty(max_n, dtype=torch.int64, device=dev),
              torch.empty(max_n, dtype=torch.int32, device=dev))
        for key in [*sched.checked, *PATHS]
    }
    t = time.perf_counter()
    for n in sorted(set(sched.sizes)):
        out = sort(model, pool[:n])
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

    calls: list[Call] = []
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
            overflow = bool(out[3])
            calls.append(Call(n, c1 - c0, overflow))
            path = PATHS[overflow]
            slot = slots.get(i) or (slots[path] if path not in first else None)
            first.setdefault(path, i)
            if slot is not None:
                if all(x.shape[0] == n for x in out[:3]):
                    kept[i] = tuple(s[:n].copy_(x) for s, x in zip(slot, out[:3]))
                    sync()
                else:  # a planted fault's answer of the wrong length
                    kept[i] = out[:3]
            i += 1
            if c1 - t0 >= seconds:
                break
        window_s = c1 - t0
    t = time.perf_counter()
    tr = trace.stop(prof) if traced else None
    if tr is not None:
        log(f"trace: read {len(tr.device)} device events in {time.perf_counter() - t:.3f} s")
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    launches = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
    kept.setdefault(len(calls) - 1, out[:3])
    del model, out

    n_calls = len(calls)
    log(f"window: {n_calls} calls, {sum(c.n for c in calls)} records in {window_s:.6f} s; "
        f"call ms p50 {stats.percentile([c.seconds for c in calls], 50) * 1e3:.4f} "
        f"p95 {stats.percentile([c.seconds for c in calls], 95) * 1e3:.4f} "
        f"max {max(c.seconds for c in calls) * 1e3:.4f}; "
        f"overflowed {sum(c.overflow for c in calls)}")
    log(f"window: kernel launches {launches} ({n_calls} calls)")
    log(f"window: peak {peak} B allocated, {base} B of it at the start; "
        f"set-up peak {setup_peak} B; pool {pool.numel()} B, answer slots "
        f"{sum(x.numel() * x.element_size() for s in slots.values() for x in s)} B; "
        f"checked calls {sorted(kept)} (first down each path: {first})")
    if tr is not None:
        log(f"trace: device busy {tr.busy_s:.6f} s of {tr.window_s:.6f} s")

    totals = dict.fromkeys(reference.LIMITS, 0)
    failed = 0
    for i in sorted(kept):
        n, off = sched.call(i)
        bad = reference.check(pool[off : off + n], *kept[i])
        log(f"check: call {i} ({n} records at {off}): {bad}")
        failed += any(bad.values())
        for k, v in bad.items():
            totals[k] += v
    del kept, slots
    ctx = Context(
        config=cfg,
        device_name=torch.cuda.get_device_name(dev) if cuda else "cpu",
        calls=calls, window_s=window_s, setup_s=setup_s, peak_bytes=peak, base_bytes=base,
        trace=tr, port_kernels=trace.port_kernel_names(manifest.ROOT / "src" / "repro_torch" / "csrc"),
    )
    return result_line(cell, ctx, traced, attempted=n_calls, failed=failed, totals=totals,
                       limits=reference.LIMITS, memory_peak_bytes=max(peak, setup_peak))


def result_line(cell: manifest.Cell, ctx: Context, traced: bool, *, attempted: int,
                failed: int, totals: dict, limits: dict, memory_peak_bytes: int) -> dict:
    """A run's result line: the cell's metrics read from ``ctx`` (its
    per-layer ones when ``traced``), the device, and last the check's
    ``totals`` beside their ``limits``, which also go to standard error
    as its last lines."""
    cuda = ctx.device_name != "cpu"
    tr = ctx.trace
    metrics = {}
    for m in cell.per_layer if traced else cell.end_to_end:
        v = manifest.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": ctx.device_name,
        "count": 1,
        "memory_peak_bytes": memory_peak_bytes,
    }
    if tr is not None:
        dev_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
    if cuda:
        from repro_torch.kernels import build

        # a checkout's first run builds the kernel library: its seconds
        # are in setup_s, and here apart (0 where it was loaded from cache)
        dev_info["build_s"] = build.build_info["seconds"] if build.build_info.get("compiled") else 0.0
        dev_info["name_power_limit"] = _power_limit()
        log(f"device: {dev_info['name_power_limit']}")
    result = {
        "correct": not any(v > limits[k] for k, v in totals.items()),
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": dev_info,
    }
    if tr is not None:
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.top_gaps()}
    result["checks"] = {k: {"value": v, "limit": limits[k]} for k, v in totals.items()}
    for k, v in totals.items():
        log(f"check {k} {v} limit {limits[k]}")
    return result
