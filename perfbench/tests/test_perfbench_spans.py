"""The program's spans in a traced window (``spans.py``) on hand-made
kineto-like events, the ``fallback_records_pct`` reader, and a traced
CPU run of each tiny cell through the harness."""

import dataclasses
import time

import pytest
from torch.autograd import DeviceType

from perfbench import harness, manifest, spans, trace

CELLS = ("gensort-uniform.hbm-arrays", "gensort-skew.hbm-arrays")
SEED = 2**35 + 11


@dataclasses.dataclass
class Ev:
    """The part of a ``_KinetoEvent`` that the readers use."""

    nm: str
    s: int
    d: int
    dev: DeviceType = DeviceType.CPU
    corr: int = 0
    kind: str = "cpu_op"
    tid: int = 1

    def name(self):
        return self.nm

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.d

    def device_type(self):
        return self.dev

    def correlation_id(self):
        return self.corr

    def activity_type(self):
        return self.kind

    def start_thread_id(self):
        return self.tid


def _kernel(name, s, d, corr, kind="kernel"):
    return Ev(name, s, d, DeviceType.CUDA, corr, kind, tid=0)


def _events():
    """A window [0, 1000) on thread 1: ``sort_device`` [100, 700) holds
    ``grid`` [150, 300) and ``fallback`` [400, 500)."""
    return [
        Ev(trace.WINDOW, 0, 1000),
        Ev("perfbench.call", 10, 980),
        Ev("repro_torch.sort_device", 100, 600),
        Ev("repro_torch.grid", 150, 150),
        Ev("aten::index", 180, 40),
        Ev("cudaLaunchKernel", 200, 5, corr=7, kind="cuda_runtime"),
        Ev("repro_torch.fallback", 400, 100),
        Ev("cudaLaunchKernelExC", 420, 5, corr=8, kind="cuda_runtime"),
        Ev("cudaMemcpyAsync", 50, 5, corr=9, kind="cuda_runtime"),
        Ev("cudaMemsetAsync", 650, 5, corr=11, kind="cuda_runtime", tid=2),
        # launched inside grid, run after it closed
        _kernel("index_elementwise_kernel", 350, 100, 7),
        _kernel("DeviceRadixSortOnesweepKernel", 460, 100, 8),
        _kernel("Memcpy DtoH", 60, 30, 9, kind="gpu_memcpy"),
        _kernel("orphan_kernel(int)", 900, 200, 10),  # no launch; clipped at the window's end
        _kernel("Memset", 660, 10, 11, kind="gpu_memset"),  # thread 2 has no spans
        # the device-side copy of a host span is no work
        _kernel("repro_torch.grid", 350, 100, 0, kind="gpu_user_annotation"),
    ]


def test_device_time_goes_to_the_span_of_the_launch():
    device, _, ops = spans.by_span(_events())
    assert device == pytest.approx({
        "repro_torch.grid": 100e-9,
        "repro_torch.fallback": 100e-9,
        spans.OUTSIDE: (30 + 100 + 10) * 1e-9,
    })
    assert ops == pytest.approx({
        "repro_torch.grid > index_elementwise_kernel": 100e-9,
        "repro_torch.fallback > DeviceRadixSortOnesweepKernel": 100e-9,
        f"{spans.OUTSIDE} > Memcpy DtoH": 30e-9,
        f"{spans.OUTSIDE} > orphan_kernel": 100e-9,
        f"{spans.OUTSIDE} > Memset": 10e-9,
    })


def test_idle_goes_to_the_innermost_span_at_the_gap_middle():
    # busy: [60, 90), [350, 450), [460, 560), [660, 670), [900, 1000)
    _, idle, _ = spans.by_span(_events())
    assert idle == pytest.approx({
        spans.OUTSIDE: (60 + 230) * 1e-9,  # [0, 60), [670, 900): middle 785
        "repro_torch.grid": 260e-9,  # [90, 350): middle 220
        "repro_torch.fallback": 10e-9,  # [450, 460)
        "repro_torch.sort_device": 100e-9,  # [560, 660): middle 610
    })


def test_the_busy_union_is_the_trace_readers():
    ev = _events()
    _, idle, _ = spans.by_span(ev)
    busy = sum(e - s for s, e in trace._union([
        (max(e.s, 0), min(e.s + e.d, 1000)) for e in ev
        if e.dev == DeviceType.CUDA and trace._is_work(e)]))
    assert sum(idle.values()) == pytest.approx((1000 - busy) * 1e-9)


def test_per_call_numbers():
    device = {"repro_torch.grid": 0.3, "repro_torch.fallback": 0.2,
              "repro_torch.compact": 0.05, spans.OUTSIDE: 0.01}
    idle = {"repro_torch.sort_device": 0.002, "repro_torch.overflow_test": 0.004,
            "repro_torch.encode_keys": 1.0, spans.OUTSIDE: 1.0}
    counters = dict(calls=10, records=1000, fallback_calls=4, fallback_records=800)
    assert spans.per_call(device, idle, counters) == pytest.approx({
        "grid_ms": 30.0, "fallback_ms": 50.0, "compact_ms": 50.0 / 6,
        "fallback_records_pct": 80.0, "sort_idle_ms": 0.6,
        "outside_pct": 100 * 0.01 / 0.56,
    })
    # skew: every call falls back, none compacts; no counters, nothing
    counters.update(fallback_calls=10)
    assert "compact_ms" not in spans.per_call({"repro_torch.grid": 0.3}, {}, counters)
    assert spans.per_call({}, {}, dict.fromkeys(counters, 0)) == {}


def _ctx():
    return harness.Context(config={}, device_name="cpu", calls=[], window_s=1.0, setup_s=1.0,
                           peak_bytes=0, base_bytes=0, trace=None, port_kernels=set())


def test_fallback_records_reader(monkeypatch):
    from repro_torch.core import learned_sort

    read = manifest.reader("fallback_records_pct")
    monkeypatch.setattr(learned_sort.sort_device, "records", 1000)
    monkeypatch.setattr(learned_sort.sort_device, "fallback_records", 800)
    assert read(_ctx()) == 80.0
    monkeypatch.setattr(learned_sort.sort_device, "records", 0)
    assert read(_ctx()) is None  # nothing counted: a control in the program's place
    monkeypatch.setattr(learned_sort, "sort_device", lambda *a, **k: None)
    assert read(_ctx()) is None  # a program without the counters


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_cpu_run_counts_what_the_harness_counts(tiny_cell, name):
    out = spans.traced_run(tiny_cell(name), SEED, 0.3, device="cpu", t_start=time.perf_counter())
    r, c = out["result"], out["counters"]
    assert r["correct"] and c["calls"] == r["attempted"]
    assert r["metrics"]["fallback_pct"]["value"] == pytest.approx(
        100 * c["fallback_calls"] / c["calls"])
    assert r["metrics"]["fallback_records_pct"]["value"] == pytest.approx(
        100 * c["fallback_records"] / c["records"])
    assert out["per_call"]["fallback_records_pct"] == r["metrics"]["fallback_records_pct"]["value"]
    assert out["device_s_by_span"] == {}  # no card: the window is one gap
    idle = out["idle_s_by_span"]
    assert len(idle) == 1 and sum(idle.values()) == pytest.approx(r["device"]["window_s"])
