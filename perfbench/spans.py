"""A traced window by the program's own spans: device and idle seconds
by the innermost ``repro_torch.*`` span.

    python3 perfbench/spans.py --workload <cell> --seed <n> [--seconds S]

The program opens a ``torch.profiler`` range at each step of its device
sort (``repro_torch.sort_device``, ``repro_torch.grid``, ...; PERF.md §3).
From the raw kineto events of a traced window, :func:`by_span` gives

* ``device``: the seconds of every kernel, copy and fill, clipped to the
  window as ``trace.stop`` clips them, by the innermost ``repro_torch.*``
  span open on the launching thread when the runtime call that launched
  it ran (``cudaLaunchKernel*``, ``cudaMemcpy*``, ``cudaMemset*``,
  matched by correlation id), else :data:`OUTSIDE`.  A kernel launched
  inside ``repro_torch.grid`` counts there though it runs after the
  span has closed;
* ``idle``: the window's idle gaps, found as ``trace.stop`` finds them,
  by the innermost ``repro_torch.*`` span open on the harness's thread at
  each gap's middle, else :data:`OUTSIDE`.

As a tool it runs one cell traced through ``harness.run_cell``, as a
``--trace 1`` run does, keeps the profiler's events, and prints one JSON
line: the harness's result line, the program's ``sort_device`` counters
over the window, both breakdowns, and the per-call numbers they give.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PREFIX = "repro_torch."
OUTSIDE = "outside the program"
_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpy", "cudaMemset")
_COUNTERS = ("calls", "records", "fallback_calls", "fallback_records")


def _innermost(spans: list, times: list) -> list:
    """The name of the innermost of the nested ``(start, end, name)``
    ``spans`` open at each of ``times``, or :data:`OUTSIDE`."""
    spans = sorted(spans, key=lambda x: (x[0], -x[1]))
    order = sorted(range(len(times)), key=times.__getitem__)
    out = [OUTSIDE] * len(times)
    stack: list = []
    j = 0
    for i in order:
        t = times[i]
        while j < len(spans) and spans[j][0] <= t:
            while stack and stack[-1][1] <= spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        if stack:
            out[i] = stack[-1][2]
    return out


def by_span(events) -> tuple[dict, dict, dict]:
    """``(device, idle, ops)``: seconds by the innermost program span, of
    the window's device work and of its idle gaps; and the device seconds
    by span and op (``"<span> > <kernel or copy>"``)."""
    from torch.autograd import DeviceType

    from perfbench import trace

    host = [e for e in events if e.device_type() == DeviceType.CPU]
    (w,) = [e for e in host if e.name() == trace.WINDOW]
    w0, w1, tid = w.start_ns(), w.start_ns() + w.duration_ns(), w.start_thread_id()
    spans: dict = {}  # thread -> its program spans
    launch: dict = {}  # correlation id -> (thread, start of the runtime call)
    for e in host:
        if e.name().startswith(PREFIX):
            s = e.start_ns()
            spans.setdefault(e.start_thread_id(), []).append((s, s + e.duration_ns(), e.name()))
        elif e.name().startswith(_LAUNCHES) and e.correlation_id():
            launch[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
    work = []  # (start, end, launching thread or None, launch time, name)
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA and d > 0 and trace._is_work(e):
            a, b = max(s, w0), min(s + d, w1)
            if b > a:
                work.append((a, b, *launch.get(e.correlation_id(), (None, 0)), e.name()))
    device: dict = {}
    ops: dict = {}
    for thread in {x[2] for x in work}:
        mine = [x for x in work if x[2] == thread]
        names = _innermost(spans.get(thread, []), [x[3] for x in mine])
        for (a, b, _, _, op), name in zip(mine, names):
            device[name] = device.get(name, 0.0) + (b - a) / 1e9
            if not op.startswith(("Memcpy", "Memset")):
                op = trace.kernel_id(op)
            key = f"{name} > {op}"
            ops[key] = ops.get(key, 0.0) + (b - a) / 1e9
    gaps, t = [], w0
    for s, e in trace._union([x[:2] for x in work]):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    idle: dict = {}
    names = _innermost(spans.get(tid, []), [(g0 + g1) // 2 for g0, g1 in gaps])
    for (g0, g1), name in zip(gaps, names):
        idle[name] = idle.get(name, 0.0) + (g1 - g0) / 1e9
    return device, idle, ops


def per_call(device: dict, idle: dict, counters: dict) -> dict:
    """The per-layer numbers the breakdowns give (PERF.md §3); a number
    whose span or counter recorded nothing is left out."""
    calls, fb = counters["calls"], counters["fallback_calls"]
    out = {}
    for name, span, n in (("grid_ms", "grid", calls), ("fallback_ms", "fallback", fb),
                          ("compact_ms", "compact", calls - fb)):
        if n and device.get(PREFIX + span):
            out[name] = device[PREFIX + span] * 1e3 / n
    if counters["records"]:
        out["fallback_records_pct"] = 100.0 * counters["fallback_records"] / counters["records"]
    steps = ("sort_device", "rmi_bucket", "grid", "overflow_test", "sort_rows", "compact",
             "fallback")
    if calls:
        out["sort_idle_ms"] = sum(idle.get(PREFIX + s, 0.0) for s in steps) * 1e3 / calls
    total = sum(device.values())
    if total:
        out["outside_pct"] = 100.0 * device.get(OUTSIDE, 0.0) / total
    return out


def traced_run(cell, seed: int, seconds: float, *, device: str, t_start: float) -> dict:
    """One ``--trace 1`` run of ``cell`` through the harness, its
    profiler's events kept: the tool's JSON line as a dict."""
    from perfbench import harness, trace
    from repro_torch.core import learned_sort

    kept: list = []
    stop = trace.stop

    def keep_events(prof):
        tr = stop(prof)
        kept.append(prof.profiler.kineto_results.events())
        return tr

    trace.stop = keep_events
    try:
        result = harness.run_cell(cell, seed, seconds, True, device=device, t_start=t_start)
    finally:
        trace.stop = stop
    counters = {k: getattr(learned_sort.sort_device, k) for k in _COUNTERS}
    device_s, idle_s, ops = by_span(kept[0])
    return {
        "workload": cell.name, "seed": seed, "result": result, "counters": counters,
        "device_s_by_span": device_s, "idle_s_by_span": idle_s,
        "per_call": per_call(device_s, idle_s, counters),
        "top_ops_by_span": sorted(ops.items(), key=lambda kv: -kv[1])[:20],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import manifest

    cell = manifest.cell(manifest.load(ROOT), args.workload, ROOT)
    out = traced_run(cell, args.seed, args.seconds, device=args.device, t_start=t_start)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
