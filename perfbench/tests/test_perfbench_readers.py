"""Rate and tail over every call, the roofline byte counts, and the
trace readers, on hand-made calls and traces."""


import pytest

from perfbench import harness, manifest, roofline, stats, trace

H100 = "NVIDIA H100 80GB HBM3"


def _ctx(calls, window_s=1.0, tr=None, device=H100, n_leaf=1024):
    return harness.Context(
        config={"n_leaf": n_leaf}, device_name=device, calls=calls,
        window_s=window_s, setup_s=12.5, peak_bytes=3 * 2**30, base_bytes=2**30, trace=tr,
        port_kernels={"rmi_kernel", "bitonic_kernel", "encode_kernel", "hist_kernel"},
    )


def _trace(device, window_s=1.0, busy_s=0.9):
    return trace.Trace(window_s=window_s, busy_s=busy_s, device=device, idle_by_host={})


def test_percentile_is_nearest_rank():
    assert stats.percentile([5, 1, 4, 2, 3], 50) == 3
    assert stats.percentile(range(1, 101), 95) == 95
    assert stats.percentile([7], 95) == 7


def test_a_stall_shows_in_rate_and_tail():
    # 100 calls of 10 ms, 6 of them stalled at 500 ms: chunk medians of
    # 10 calls would all read 10 ms; the window's p95 and rate do not
    calls = [harness.Call(1_000_000, 0.5 if i % 17 == 0 else 0.01, False) for i in range(100)]
    window = sum(c.seconds for c in calls)
    ctx = _ctx(calls, window_s=window)
    assert manifest.reader("call_ms_p95")(ctx) == pytest.approx(500.0)
    assert manifest.reader("sort_Mrec_s")(ctx) == pytest.approx(100 / window)


def test_end_to_end_readers():
    ctx = _ctx([harness.Call(10, 0.1, True), harness.Call(30, 0.1, False)])
    assert manifest.reader("setup_s")(ctx) == 12.5
    assert manifest.reader("peak_GiB")(ctx) == 2.0
    assert manifest.reader("fallback_pct")(ctx) == 50.0
    assert manifest.reader("peak_GiB")(_ctx([], device="cpu")) is None


def test_roofline_bytes():
    assert roofline.rmi_bytes(1000, 10) == 1000 * 12 + 10 * 28
    assert roofline.sort_rows_bytes(1000) == 24_000
    assert roofline.hbm_bytes_per_s(H100) == 3.35e12
    assert roofline.hbm_bytes_per_s("some other card") is None


def test_roofline_readers():
    n = 1 << 27
    calls = [harness.Call(n, 0.08, False), harness.Call(n, 0.08, True)]
    rmi_s, rows_s = 0.004, 0.02
    tr = _trace([
        ("rmi_kernel(long long const*, long long const*, long long, (anonymous namespace)::Model)", 0, int(rmi_s * 1e9)),
        ("void (anonymous namespace)::bitonic_kernel<32, false, 128>(long long const*, int)", 0, int(rows_s * 1e9)),
        ("void at::native::index_elementwise_kernel<128, 4>(long)", 0, 30_000_000),
        ("Memcpy DtoH (Device -> Pageable)", 0, 10_000_000),
    ])
    ctx = _ctx(calls, tr=tr, n_leaf=65536)
    rmi = manifest.reader("rmi_roofline")(ctx)
    assert rmi == pytest.approx(100 * 2 * roofline.rmi_bytes(n, 65536) / 3.35e12 / rmi_s)
    rows = manifest.reader("sort_rows_roofline")(ctx)  # the overflowed call sorted no rows
    assert rows == pytest.approx(100 * roofline.sort_rows_bytes(n) / 3.35e12 / rows_s)
    assert manifest.reader("torch_ops_ms")(ctx) == pytest.approx(40.0 / 2)
    assert manifest.reader("device_idle_pct")(ctx) == pytest.approx(10.0)


def test_readers_return_nothing_without_a_trace():
    ctx = _ctx([harness.Call(10, 0.1, False)])
    for name in ("rmi_roofline", "sort_rows_roofline", "torch_ops_ms", "device_idle_pct"):
        assert manifest.reader(name)(ctx) is None
    ctx = _ctx([harness.Call(10, 0.1, True)], tr=_trace([("rmi_kernel(x)", 0, 10)]))
    assert manifest.reader("sort_rows_roofline")(ctx) is None


def test_kernel_names():
    assert trace.kernel_id("void (anonymous namespace)::bitonic_kernel<32, true, 128>(long long const*, int)") == "bitonic_kernel"
    assert trace.kernel_id("rmi_kernel(long long const*)") == "rmi_kernel"
    names = trace.port_kernel_names(manifest.ROOT / "src" / "repro_torch" / "csrc")
    assert {"encode_kernel", "rmi_kernel", "bitonic_kernel", "hist_kernel"} <= names


def test_union_and_idle_attribution():
    assert trace._union([(5, 7), (0, 2), (1, 3), (7, 9)]) == [[0, 3], [5, 9]]
    host = [(0, 100, "perfbench.call"), (10, 40, "aten::nonzero"),
            (20, 30, "cudaStreamSynchronize"), (60, 70, "aten::cumsum")]
    gaps = [(22, 28), (45, 55), (62, 68), (150, 160)]
    got = trace._attribute(gaps, host)
    assert got == pytest.approx({
        "aten::nonzero > cudaStreamSynchronize": 6e-9,
        "perfbench.call": 10e-9,
        "aten::cumsum": 6e-9,
        "host outside any op": 10e-9,
    })


def test_top_lists_keep_every_digit():
    tr = _trace([("a", 0, 3), ("b", 0, 5), ("a", 10, 13)])
    assert tr.top_ops() == [["a", 6e-9], ["b", 5e-9]]
    tr.idle_by_host = {"x": 0.123456789, "y": 0.5}
    assert tr.top_gaps(1) == [["y", 0.5]]
