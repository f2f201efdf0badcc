"""Port parity: the fused segmented sort graphs and the batched executor
against ``repro.kernels.fused`` / ``repro.core.executor``.

The port's grid graph runs on the CPU with its kernels' plain versions
(the wrappers take the plain path for CPU tensors); the JAX graph runs
its Pallas encode and RMI kernels in interpret mode.  Permutations, the overflow flag and the
executor's dispatch counters must be equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import encoding as jenc  # noqa: E402
from repro.core import executor as jex  # noqa: E402
from repro.core import rmi as jrmi  # noqa: E402
from repro.core.format import GENSORT as JGENSORT  # noqa: E402
from repro.data import gensort  # noqa: E402
from repro.kernels import fused as jfused  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import executor as tex  # noqa: E402
from repro_torch.core import rmi as trmi  # noqa: E402
from repro_torch.core.format import GENSORT as TGENSORT  # noqa: E402
from repro_torch.kernels import fused as tfused  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402


def _model():
    return jrmi.fit(gensort.uniform_keys(4096, seed=0), n_leaf=256)


def _row_plan(n, n_segs, s_max):
    bounds = np.linspace(0, n, n_segs + 1).astype(np.int64)
    seg = np.repeat(np.arange(n_segs, dtype=np.int32), np.diff(bounds))
    n_rows, capacity = jfused.plan_batch(1 << max(0, (n - 1).bit_length()), s_max)
    alloc = np.ones(n_segs, dtype=np.int64)
    alloc += (n_rows - n_segs) * np.diff(bounds) // n
    row_base = np.zeros(s_max, np.int32)
    rows_per_seg = np.zeros(s_max, np.int32)
    rows_per_seg[:n_segs] = alloc
    row_base[:n_segs] = np.concatenate([[0], np.cumsum(alloc)[:-1]])
    return seg, row_base, rows_per_seg, n_rows, capacity


def _both(model, keys, seg, row_base, rows_per_seg, n_rows, capacity):
    perm_j, over_j = jfused.fused_segmented_sort(
        model, jnp.asarray(keys), jnp.asarray(seg), jnp.asarray(row_base),
        jnp.asarray(rows_per_seg), n_rows=n_rows, capacity=capacity,
        use_kernels=False,
    )
    perm_t, over_t = tfused.fused_segmented_sort(
        trmi.params_from_numpy(model), torch.from_numpy(keys),
        torch.from_numpy(seg), torch.from_numpy(row_base),
        torch.from_numpy(rows_per_seg), n_rows=n_rows, capacity=capacity,
    )
    return (np.asarray(perm_j), bool(np.asarray(over_j))), (perm_t, over_t)


@pytest.mark.parametrize(
    "n,n_segs",
    [
        (n, s)
        for s in (1, 3)
        for n in (1, 2, 7, 255, 256, 257, 1023, 1024, 1025)
        if n >= s  # every segment holds a record
    ],
)
def test_grid_perm_equals_jax_and_oracle(n, n_segs):
    model = _model()
    keys = gensort.uniform_keys(n, seed=n)[:, :8].copy()
    seg, row_base, rps, n_rows, capacity = _row_plan(n, n_segs, 8)
    (perm_j, over_j), out = _both(
        model, keys, seg, row_base, rps, n_rows, capacity
    )
    hi, lo = jenc.encode_np(keys)
    want = jref.segmented_sort_ref(seg, hi, lo)
    np.testing.assert_array_equal(perm_j, want)
    np.testing.assert_array_equal(tref.segmented_sort_ref(seg, hi, lo), want)
    perm_t, over_t = out
    assert perm_t.dtype == torch.int32
    np.testing.assert_array_equal(perm_t.numpy(), want)
    assert over_t == over_j


def test_all_duplicates_overflow_flag_set_in_both():
    n, s_max = 512, 8
    model = _model()
    keys = np.tile(gensort.uniform_keys(1, seed=5)[:, :8], (n, 1))
    seg = np.zeros(n, np.int32)
    n_rows, capacity = jfused.plan_batch(n, s_max)
    row_base = np.zeros(s_max, np.int32)
    rps = np.zeros(s_max, np.int32)
    rps[0] = n_rows
    (perm_j, over_j), (perm_t, over_t) = _both(
        model, keys, seg, row_base, rps, n_rows, capacity
    )
    assert over_j and over_t
    np.testing.assert_array_equal(perm_t.numpy(), perm_j)
    # the fast path alone reports the flag as a tensor, unread
    _, flag, _, _ = tfused.grid_fast_path(
        trmi.params_from_numpy(model), torch.from_numpy(keys),
        torch.from_numpy(seg), torch.from_numpy(row_base),
        torch.from_numpy(rps), n_rows=n_rows, capacity=capacity,
    )
    assert isinstance(flag, torch.Tensor) and bool(flag)


@pytest.mark.parametrize("n,n_segs", [(1, 1), (1000, 3), (4096, 5)])
def test_flat_graph_equals_jax(n, n_segs):
    rng = np.random.default_rng(n)
    keys = gensort.uniform_keys(n, seed=n)[:, :8].copy()
    keys[rng.random(n) < 0.3] = keys[0]  # duplicate keys across segments
    seg = rng.integers(0, n_segs, size=n).astype(np.int32)
    want = np.asarray(jfused.flat_segmented_sort(jnp.asarray(keys), jnp.asarray(seg)))
    got = tfused.flat_segmented_sort(torch.from_numpy(keys), torch.from_numpy(seg))
    np.testing.assert_array_equal(got.numpy(), want)


def test_pad_target_and_plan_batch_equal_jax():
    for n in list(range(1, 300)) + [4097, 12_345, 1_333_333, (1 << 20) + 1]:
        assert tfused.pad_target(n) == jfused.pad_target(n)
        for s in (1, 15, 32):
            assert tfused.plan_batch(n, s) == jfused.plan_batch(n, s)
    # the main path's batch at the 256 MB budget: two ~667k partitions
    assert tfused.pad_target(1_333_333) == 1_441_792
    assert tfused.plan_batch(1_441_792, 15) == (8192, 1024)


# ---------------------------------------------------------------------------
# Executor: counters and bytes equal to the reference's
# ---------------------------------------------------------------------------


def _records(sizes, seed=0, dup=False):
    rng = np.random.default_rng(seed)
    recs = gensort.make_records(sum(sizes), seed=seed)
    if dup:
        recs[:, : gensort.KEY_BYTES] = recs[0, : gensort.KEY_BYTES]
    else:
        kv = recs[:, : gensort.KEY_BYTES].copy().view("S10").reshape(-1)
        recs = recs[np.argsort(kv, kind="stable")]
    parts, off = [], 0
    for m in sizes:
        part = recs[off : off + m]
        off += m
        parts.append(part[rng.permutation(m)].tobytes())
    return parts


def _run(ex, fmt, parts):
    got = dict(ex.sort_iter((i, fmt.parse_blob(b)) for i, b in enumerate(parts)))
    return [got[i].tobytes() for i in range(len(parts))]


@pytest.mark.parametrize(
    "sizes,flat,kw",
    [
        ([1, 2, 3], True, {}),
        ([100, 1023, 1024, 1025, 7], True, {}),
        ([5000, 4, 3000], True, {}),
        ([100, 1023, 1024, 1025, 7], False, {}),
        ([400] * 24, True, {}),
        ([int(s) for s in np.random.default_rng(7).integers(2, 3000, 40)],
         True, {"batch_slots": 4096}),
    ],
)
def test_executor_counters_equal_jax(sizes, flat, kw):
    model = _model()
    parts = _records(sizes, seed=len(sizes))
    jx = jex.BatchedDeviceExecutor(model, flat=flat, **kw)
    tx = tex.BatchedDeviceExecutor(
        trmi.params_from_numpy(model), device="cpu", flat=flat, **kw
    )
    assert _run(tx, TGENSORT, parts) == _run(jx, JGENSORT, parts)
    for attr in ("dispatches", "batch_slots", "batch_records",
                 "jit_compiles", "fallbacks", "occupancy"):
        assert getattr(tx, attr) == getattr(jx, attr), attr


def test_executor_duplicate_fallback_equal_jax():
    """The grid's overflow -> stable fallback, counted in ``fallbacks``."""
    model = _model()
    parts = _records([2000, 500], seed=2, dup=True)
    jx = jex.BatchedDeviceExecutor(model, flat=False)
    tx = tex.BatchedDeviceExecutor(
        trmi.params_from_numpy(model), device="cpu", use_kernels=True
    )
    assert not tx.flat
    assert _run(tx, TGENSORT, parts) == _run(jx, JGENSORT, parts)
    assert tx.fallbacks == jx.fallbacks >= 1
    assert tx.dispatches == jx.dispatches


def test_make_executor_resolves_like_jax_on_cpu():
    model = trmi.params_from_numpy(_model())
    assert isinstance(tex.make_executor(model, device="cpu"), tex.HostSortExecutor)
    ex = tex.make_executor(model, device="cpu", device_sort=True)
    assert isinstance(ex, tex.BatchedDeviceExecutor) and ex.flat
    ex = tex.make_executor(model, device="cpu", use_kernels=True)
    assert isinstance(ex, tex.BatchedDeviceExecutor) and not ex.flat
    with pytest.raises(ValueError):
        tex.make_executor(model, device="cpu", executor="warp_drive")
    ex = tex.make_executor(model, device="cpu", executor="per_partition")
    assert isinstance(ex, tex.PerPartitionDeviceExecutor)
    with pytest.raises(NotImplementedError):
        tex.make_executor(model, device="cpu", executor="mesh")


def test_make_executor_cuda_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tex.make_executor(trmi.params_from_numpy(_model()), device="cuda")


@pytest.mark.parametrize("build", ["make_executor", "BatchedDeviceExecutor"])
def test_executor_defaults_to_the_card(build):
    """Without ``device=`` an executor is built for the card, so on a
    machine without one it raises instead of running on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(tex, build)(trmi.params_from_numpy(_model()))
