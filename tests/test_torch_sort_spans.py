"""The device sort's tracing: ``sort_device``'s counters, its profiler
spans and their nesting, and the span helper's no-op when nothing
traces (``core/learned_sort.py``, ``core/stages/stats.py``)."""

import numpy as np
import pytest
import torch

from repro_torch.core import (
    distributed,
    encoding,
    learned_sort,
    partition,
    rmi,
)
from repro_torch.core.stages import stats
from repro_torch.data import gensort
from repro_torch.kernels import ops
from repro_torch.launch import mesh as tmesh

N = 4096
COUNTERS = ("calls", "records", "fallback_calls", "fallback_records")
# a step's span -> the span it opens under, on each path
ROWS_TREE = {
    "repro_torch.rmi_bucket": "repro_torch.sort_device",
    "repro_torch.grid": "repro_torch.sort_device",
    "repro_torch.overflow_test": "repro_torch.sort_device",
    "repro_torch.sort_rows": "repro_torch.sort_device",
    "repro_torch.compact": "repro_torch.sort_device",
    "repro_torch.sort_device": None,
    "repro_torch.encode_keys": None,
}
# the flood's overflow is known from the counts: no grid is built
FLOOD_TREE = {
    **{k: v for k, v in ROWS_TREE.items()
       if k not in ("repro_torch.grid", "repro_torch.sort_rows",
                    "repro_torch.compact")},
    "repro_torch.fallback": "repro_torch.sort_device",
}


def _keys(kind: str) -> np.ndarray:
    keys = gensort.uniform_keys(N, seed=5)
    if kind == "flood":  # a duplicate flood: every key in one bucket
        keys = np.repeat(keys[:1], N, axis=0)
    return keys


def _sort(kind: str):
    keys = _keys(kind)
    model = rmi.fit(gensort.uniform_keys(N, seed=5), n_leaf=64)
    hi, lo = ops.encode_keys(torch.from_numpy(keys))
    return learned_sort.sort_device(model, hi, lo, return_overflow=True)


def _counters() -> dict:
    return {k: getattr(learned_sort.sort_device, k) for k in COUNTERS}


@pytest.mark.parametrize(
    "kind,want",
    [("rows", dict(calls=1, records=N, fallback_calls=0, fallback_records=0)),
     ("flood",
      dict(calls=1, records=N, fallback_calls=1, fallback_records=N))],
)
def test_counters_count_calls_records_and_the_fallback(kind, want):
    learned_sort.reset_counters()
    *_, overflow = _sort(kind)
    assert overflow == (kind == "flood")
    assert _counters() == want
    _sort(kind)
    assert _counters() == {k: 2 * v for k, v in want.items()}
    learned_sort.reset_counters()
    assert set(_counters().values()) == {0}
    _sort(kind)
    ops.reset_launches()  # one reset starts every count of the path at 0
    assert set(_counters().values()) == {0}


def test_the_distributed_step_is_counted():
    keys = gensort.uniform_keys(N, seed=6)
    hi, lo = (torch.from_numpy(w.astype(np.int64))
              for w in encoding.encode_np(keys))
    mesh = tmesh.make_data_mesh(device="cpu")
    fn = distributed.make_sort_fn(
        mesh, mesh.axis_names, rmi.fit(keys, n_leaf=64), N
    )
    learned_sort.reset_counters()
    fn(hi, lo, torch.arange(N, dtype=torch.int32))
    out_width = partition.route_capacity(N, 1, 1.5)  # one rank's slots
    assert _counters()["calls"] == 1
    assert _counters()["records"] == out_width


def _program_span(e):
    """The name of the innermost program span enclosing event ``e``."""
    p = e.cpu_parent
    while p is not None and not p.name.startswith("repro_torch."):
        p = p.cpu_parent
    return p.name if p else None


def _parents(prof) -> dict:
    """Each ``repro_torch.*`` span's innermost enclosing program span."""
    out = {}
    for e in prof.events():
        if e.name.startswith("repro_torch."):
            out.setdefault(e.name, set()).add(_program_span(e))
    return out


CPU = [torch.profiler.ProfilerActivity.CPU]
STEPS = ("rmi_bucket", "overflow_test", "grid", "sort_rows", "compact",
         "fallback")


@pytest.mark.parametrize(
    "kind,tree", [("rows", ROWS_TREE), ("flood", FLOOD_TREE)]
)
def test_spans_nest_under_sort_device(kind, tree):
    _sort(kind)  # the first call's one-time work stays out of the trace
    with torch.profiler.profile(activities=CPU) as prof:
        _sort(kind)
    assert _parents(prof) == {k: {v} for k, v in tree.items()}
    starts = {e.name: e.time_range.start for e in prof.events()
              if e.name.startswith("repro_torch.")}
    steps = [s for s in STEPS if "repro_torch." + s in tree]
    assert sorted(steps, key=lambda s: starts["repro_torch." + s]) == steps


def _ops_by_span(prof) -> dict:
    """``(innermost program span, aten op) -> count`` of one trace."""
    out: dict = {}
    for e in prof.events():
        if not e.name.startswith("repro_torch."):
            key = (_program_span(e), e.name)
            out[key] = out.get(key, 0) + 1
    return out


@pytest.mark.parametrize("kind", ["rows", "flood"])
def test_one_count_and_one_sync_a_call_both_before_the_grid(kind):
    """Each call counts the bucket ids once (one ``scatter_add_``) and
    waits on the device once (one ``_local_scalar_dense``), both inside
    ``overflow_test``; the grid reuses the counts, and a call that
    overflows builds no grid at all (no ``scatter_``, no span)."""
    _sort(kind)
    with torch.profiler.profile(activities=CPU) as prof:
        _sort(kind)
    ops_ = _ops_by_span(prof)

    def count(op, span=None):
        return sum(v for (s, o), v in ops_.items()
                   if o == op and span in (None, s))

    for op in ("aten::_local_scalar_dense", "aten::scatter_add_"):
        assert count(op) == count(op, "repro_torch.overflow_test") == 1
        assert count(op, "repro_torch.grid") == 0
    names = {e.name for e in prof.events()}
    if kind == "flood":
        assert count("aten::scatter_") == 0
        assert "repro_torch.grid" not in names
    else:
        assert count("aten::scatter_", "repro_torch.grid") == 2


def test_no_profiler_no_span(monkeypatch):
    opened = []
    monkeypatch.setattr(stats, "record_function", opened.append)
    assert not torch.autograd._profiler_enabled()
    assert stats.span("a") is stats.span("b") is stats._NO_SPAN
    _sort("rows")
    _sort("flood")
    assert opened == []
    with torch.profiler.profile(activities=CPU):
        stats.span("repro_torch.x")
    assert opened == ["repro_torch.x"]
