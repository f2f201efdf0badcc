"""The full-key cell (``gensort-skew-valsort.hbm-fullkey``): its
reference against an independent stable sort, its check's counts, the
driver end to end at a CPU size, every control and planted fault caught
on every seed, and its two per-layer readers on hand-made traces.  The
marked test runs the program, the controls and the faults on a card."""

import copy
import time

import numpy as np
import pytest
import torch

from perfbench import (full_key_reference, full_key_roofline, gensort_keys, harness, manifest,
                       trace, traffic)

CELL = "gensort-skew-valsort.hbm-fullkey"
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def drv():
    return manifest.driver("full_key")


def _keys(n, seed, skewed=True, width=10):
    rng = np.random.default_rng(seed)
    keys = rng.integers(32, 127, (n, width), dtype=np.uint8)
    if skewed:  # a few 6-byte prefixes, two more bytes from 3 values: ties
        keys[:, :6] = rng.integers(32, 127, (4, 6), dtype=np.uint8)[rng.integers(0, 4, n)]
        keys[:, 6:8] = rng.integers(32, 35, (n, 2), dtype=np.uint8)
        keys[:, 8:] = rng.integers(32, 36, (n, width - 8), dtype=np.uint8)
    return keys


@pytest.mark.parametrize("width", [8, 10, 12])
@pytest.mark.parametrize("skewed", [True, False])
def test_reference_is_a_stable_memcmp_sort(skewed, width):
    keys = _keys(5000, width, skewed, width)
    hi, lo, tail, perm = full_key_reference.stable_sort(torch.from_numpy(keys))
    want = np.lexsort(keys.T[::-1])  # column 0 the primary key; stable
    np.testing.assert_array_equal(perm.numpy(), want)
    k = np.pad(keys[want].astype(np.int64), ((0, 0), (0, 12 - width)))
    for w, got in enumerate((hi, lo, tail)):
        np.testing.assert_array_equal(
            got.numpy(), k[:, 4 * w : 4 * w + 4] @ (256 ** np.arange(3, -1, -1)))
    bad = full_key_reference.check(torch.from_numpy(keys), hi, lo, tail, perm, block=999)
    assert bad == dict.fromkeys(full_key_reference.LIMITS, 0)


def test_check_counts_each_kind_of_fault():
    keys = torch.from_numpy(_keys(4000, 1))
    ans = full_key_reference.stable_sort(keys)
    k = keys[ans[3].long()]
    same = np.flatnonzero((k[1:] == k[:-1]).all(1).numpy())
    diff = np.flatnonzero(~(k[1:] == k[:-1]).all(1).numpy())
    assert same.size and diff.size

    def swapped(i):
        out = [x.clone() for x in ans]
        for x in out:
            x[[i, i + 1]] = x[[i + 1, i]]
        return out

    def count(out):
        return full_key_reference.check(keys, *out, block=1000)

    assert count(swapped(int(diff[0])))["order_bad"] == 1
    bad = count(swapped(int(same[0])))
    assert bad["ties_bad"] == 1 and bad["order_bad"] == 0
    tail = ans[2].clone()
    tail[7] += 1
    assert count((ans[0], ans[1], tail, ans[3]))["words_bad"] == 1
    perm = ans[3].clone()
    perm[5] = perm[6]
    assert count((*ans[:3], perm))["perm_bad"] >= 2
    assert count((*ans[:3], ans[3][:-1]))["perm_bad"] >= 1
    with pytest.raises(ValueError):
        full_key_reference.encode_words(torch.zeros((2, 13), dtype=torch.uint8))


def _run(tiny_cell, drv, sort=None, seed=2**35 + 3, traced=False):
    return drv.run(tiny_cell(CELL), seed, 0.3, traced, device="cpu",
                   t_start=time.perf_counter(), sort=sort)


@pytest.mark.parametrize("traced", [False, True])
def test_the_program_is_correct(tiny_cell, drv, traced):
    r = _run(tiny_cell, drv, traced=traced)
    assert r["correct"] and r["failed"] == 0
    assert list(r["checks"]) == ["perm_bad", "words_bad", "order_bad", "ties_bad"]
    assert list(r)[-1] == "checks"
    if not traced:  # peak_GiB reads a card's memory only
        assert set(r["metrics"]) == {"sort_Mrec_s", "setup_s"}
    else:  # the program's counters; a CPU trace holds no device time
        assert set(r["metrics"]) == {"fallback_pct", "fallback_records_pct"}


@pytest.mark.parametrize("seed", range(1, 5))
@pytest.mark.parametrize("path", ["prefix8", "f64", "tail"])
def test_every_control_and_fault_is_caught_on_every_seed(tiny_cell, drv, path, seed):
    r = _run(tiny_cell, drv, drv.sort_for(path), seed=seed)
    assert not r["correct"] and r["failed"] >= 1
    assert r["checks"]["order_bad"]["value"] > 0


@pytest.mark.parametrize("seed", range(1, 5))
@pytest.mark.parametrize("path", ["rows", "fallback"])
def test_a_fault_in_one_path_is_caught_on_every_seed(tiny_cell, drv, path, seed):
    """The seed's calls in order, as a window makes them, until one takes
    the path (a window's length is the clock's, so this is not); its
    answer, with the fault planted in that path, fails the check."""
    cell = tiny_cell(CELL)
    sched = traffic.Schedule(cell.traffic, seed)
    gen = torch.Generator()
    gen.manual_seed(sched.device_seed)
    pool = gensort_keys.random_records(sched.pool_records, cell.config, gen, "cpu")
    model, _ = harness.train_model(cell.config, torch.device("cpu"))
    sort = drv.sort_for(path)
    for i in range(12):
        n, off = sched.call(i)
        out = sort(model, pool[off : off + n])
        if harness.PATHS[bool(out[4])] == path:
            break
    else:
        pytest.fail(f"no call of the first 12 took the {path} path")
    bad = full_key_reference.check(pool[off : off + n], *out[:4])
    assert bad["order_bad"] > 0


def test_the_parent_without_the_entry_point_fails_before_any_data(drv, monkeypatch):
    from repro_torch.kernels import ops

    monkeypatch.delattr(ops, "encode_full_keys")
    with pytest.raises(AttributeError):
        drv.program_sort()


def _ctx(drv, calls, tr=None, by_span=None):
    return drv.FullKeyContext(
        config={"key_bytes": 10, "n_leaf": 1024}, device_name=H100, calls=calls,
        window_s=1.0, setup_s=1.0, peak_bytes=0, base_bytes=0, trace=tr,
        port_kernels={"encode_full_kernel"}, span_device_s=by_span or {})


def test_per_layer_readers(drv):
    n = 1 << 26
    calls = [harness.Call(n, 0.05, True), harness.Call(n, 0.05, True)]
    enc_s = 0.002
    tr = trace.Trace(window_s=1.0, busy_s=0.9, idle_by_host={}, device=[
        ("(anonymous namespace)::encode_full_kernel(unsigned char const*, long long, int, "
         "long long*, long long*, long long*, long long)", 0, int(enc_s * 1e9)),
        ("(anonymous namespace)::encode_kernel(uint2 const*, long long*, long long*, long long)",
         0, 10**9),
    ])
    assert full_key_roofline.encode_full_bytes(n, 10) == n * 22
    got = manifest.reader("encode_full_roofline")(_ctx(drv, calls, tr))
    assert got == pytest.approx(100 * 2 * n * 22 / 3.35e12 / enc_s)
    assert manifest.reader("encode_full_roofline")(_ctx(drv, calls)) is None
    read = manifest.reader("full_key_ms")
    assert read(_ctx(drv, calls, tr, {"repro_torch.full_key": 0.03})) == pytest.approx(15.0)
    # a program without the span, or a harness context without the field
    assert read(_ctx(drv, calls, tr, {"repro_torch.fallback": 0.03})) is None
    assert read(harness.Context(config={}, device_name=H100, calls=calls, window_s=1.0,
                                setup_s=1.0, peak_bytes=0, base_bytes=0, trace=tr,
                                port_kernels=set())) is None


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["program", "prefix8", "f64", "tail", "rows", "fallback"])
def test_on_the_card(tiny_cell, drv, path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = copy.deepcopy(tiny_cell(CELL))
    cell.config.update(file_records=1 << 30, records_per_call_max=1 << 27, n_leaf=65536)
    cell.traffic.update(sizes=[1 << 22, 1 << 24])
    if path == "rows":  # skewed arrays of 2^22 still overflow a row; uniform ones do not
        del cell.config["skew"]
    sort = None if path == "program" else drv.sort_for(path)
    r = drv.run(cell, 7, 2.0, path == "program", device="cuda",
                t_start=time.perf_counter(), sort=sort)
    assert r["correct"] == (path == "program")
    if path == "program":
        assert set(r["metrics"]) == {
            "full_key_ms", "encode_full_roofline", "fallback_pct", "fallback_records_pct",
            "torch_ops_ms", "rmi_roofline", "device_idle_pct"}
