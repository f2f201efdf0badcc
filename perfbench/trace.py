"""The traced run: ``torch.profiler`` over the window, read in memory.

Nothing is written to disk.  From the raw kineto events (one Python
object an event; ``key_averages`` would build a tree and take minutes
at 10^5-10^6 events) :func:`stop` takes

* the window: the harness's ``perfbench.window`` span, less any
  ``perfbench.pause`` span in it (the harness's own work with the clock
  stopped, such as copying a checked answer to the host);
* the device's work: kernels, copies and fills, clipped to the window;
  ``busy_s`` is the length of their union;
* the idle gaps of the device inside the window, each named by what the
  host was doing at its middle: the innermost host op or harness span
  open then on the harness's thread.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path

WINDOW = "perfbench.window"
PAUSE = "perfbench.pause"
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)")
_DEVICE_WORK = ("kernel", "memcpy", "memset")


def port_kernel_names(csrc: Path) -> set[str]:
    """Names of the ``__global__`` functions in the program's CUDA
    sources: the kernels the port's own library launches."""
    names = set()
    for src in sorted(csrc.glob("*.cu")):
        names.update(_GLOBAL.findall(src.read_text()))
    return names


def kernel_id(name: str) -> str:
    """The bare function name of a demangled kernel name
    (``void ns::f<4, true>(long*, ...)`` -> ``f``)."""
    head = re.split(r"[<(]", name.replace("(anonymous namespace)::", ""), maxsplit=1)[0]
    return head.split()[-1].split("::")[-1] if head.strip() else name


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    # (name, start_ns, end_ns) of every kernel, copy and fill in the window
    device: list
    # total idle seconds inside the window, by what the host was doing
    idle_by_host: dict

    def seconds(self, pred) -> float:
        """Device seconds of the work whose name satisfies ``pred``."""
        return sum(e - s for name, s, e in self.device if pred(name)) / 1e9

    def kernel_seconds(self, kernel: str) -> float:
        return self.seconds(lambda name: kernel_id(name) == kernel)

    def top_ops(self, k: int = 10) -> list:
        by: dict = {}
        for name, s, e in self.device:
            by[name] = by.get(name, 0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[name, ns / 1e9] for name, ns in top]

    def top_gaps(self, k: int = 10) -> list:
        top = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:k]
        return [[name, s] for name, s in top]


def start(cuda: bool):
    """A running profiler over the host and, with ``cuda``, the card."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


def _union(intervals: list) -> list:
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _minus(t0: int, t1: int, cuts: list) -> list:
    """``[t0, t1)`` less the sorted, disjoint intervals ``cuts``."""
    out, t = [], t0
    for s, e in cuts:
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t1 > t:
        out.append((t, t1))
    return out


def _label(stack: list) -> str:
    """The innermost open host op; a runtime call is named with its op."""
    if not stack:
        return "host outside any op"
    name = stack[-1][2]
    if name.startswith("cu") and len(stack) > 1:
        return f"{stack[-2][2]} > {name}"
    return name


def _attribute(gaps: list, host: list) -> dict:
    """Idle seconds by the host activity at each gap's middle; ``host``
    holds one thread's nested (start, end, name) spans."""
    host = sorted(host, key=lambda x: (x[0], -x[1]))
    out: dict = {}
    stack: list = []
    j = 0
    for g0, g1 in gaps:
        t = (g0 + g1) // 2
        while j < len(host) and host[j][0] <= t:
            while stack and stack[-1][1] <= host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        label = _label(stack)
        out[label] = out.get(label, 0.0) + (g1 - g0) / 1e9
    return out


def _is_work(e) -> bool:
    """A device event that is work (a kernel, copy or fill), not the
    device-side copy of a host span.  Older kineto bindings name no
    activity type; there a span is known by its name."""
    kind = e.activity_type() if hasattr(e, "activity_type") else None
    if kind is not None:
        return any(k in kind for k in _DEVICE_WORK)
    if hasattr(e, "is_user_annotation") and e.is_user_annotation():
        return False
    return not e.name().startswith("perfbench.")


def stop(prof) -> Trace:
    """Stop ``prof`` and read the window it traced."""
    from torch.autograd import DeviceType

    prof.__exit__(None, None, None)
    events = prof.profiler.kineto_results.events()
    spans = [e for e in events if e.name() == WINDOW and e.device_type() == DeviceType.CPU]
    if len(spans) != 1:
        raise RuntimeError(f"expected one {WINDOW} span, found {len(spans)}")
    w = spans[0]
    w0, w1, tid = w.start_ns(), w.start_ns() + w.duration_ns(), w.start_thread_id()
    pauses = _union([(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                     if e.name() == PAUSE and e.device_type() == DeviceType.CPU
                     and e.start_thread_id() == tid])
    segments = _minus(w0, w1, pauses)
    device, host = [], []
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if d > 0 and _is_work(e):
                for g0, g1 in segments:
                    a, b = max(s, g0), min(s + d, g1)
                    if b > a:
                        device.append((e.name(), a, b))
        elif e.start_thread_id() == tid and e is not w and s >= w0 and s < w1:
            host.append((s, s + d, e.name()))
    busy = _union([(s, e) for _, s, e in device])
    gaps = [g for g0, g1 in segments for g in _minus(g0, g1, busy)]
    return Trace(
        window_s=sum(g1 - g0 for g0, g1 in segments) / 1e9,
        busy_s=sum(e - s for s, e in busy) / 1e9,
        device=device,
        idle_by_host=_attribute(gaps, host),
    )
