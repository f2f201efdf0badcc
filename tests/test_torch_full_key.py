"""The full-key device sort: ``learned_sort.sort_device(model, hi, lo,
tail)`` orders keys of up to 12 bytes by the whole key, stably, on both
of its paths (the row sorter, whose rows may hold 8-byte ties, and the
stable fallback), as the plain reference (``testing/full_key_ref``)
and an independent ``np.lexsort`` order them; the tail word and its
encode (``ops.encode_full_keys``, the kernel's plain twin on the CPU);
a call without tail words runs the same ops as before them; the
per-partition chain needs no host touch-up for such keys; and the
port's full-key permutation equals the JAX chain's, its 8-byte
``sort_device`` followed by the executor's memcmp touch-up.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.core import executor as jexec  # noqa: E402
from repro.core import learned_sort as jls  # noqa: E402
from repro.core import rmi as jrmi  # noqa: E402
from repro_torch.core import encoding, executor, learned_sort  # noqa: E402
from repro_torch.core import rmi as trmi  # noqa: E402
from repro_torch.core.format import RecordBlock  # noqa: E402
from repro_torch.data import gensort  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.testing import full_key_ref  # noqa: E402

SIZES = (1 << 10, 1 << 13, 1 << 16)
# grids that send a call down each path: 16 rows as wide as the input
# hold any bucket, the skewed spike's too; rows of one slot hold none
PATHS = {"rows": dict(n_buckets=16, capacity_factor=8.0),
         "fallback": dict(capacity_factor=1e-3)}


def _keys(kind: str, n: int, width: int = 10, seed: int = 0) -> np.ndarray:
    gen = gensort.skewed_keys if kind == "skewed" else gensort.uniform_keys
    keys = gen(n, seed=seed)
    if width > keys.shape[1]:
        more = np.random.default_rng(seed + 1).integers(
            32, 127, (n, width - keys.shape[1]), dtype=np.uint8)
        keys = np.concatenate([keys, more], axis=1)
    return np.ascontiguousarray(keys[:, :width])


def _lexsort(keys: np.ndarray) -> np.ndarray:
    """The stable memcmp order of the rows, by NumPy (column 0 first)."""
    return np.lexsort(keys.T[::-1])


def _sort(keys: np.ndarray, path: str, tail=True, model=None):
    t = torch.from_numpy(keys)
    hi, lo, tl = ops.encode_full_keys(t)
    model = model or trmi.fit(keys, n_leaf=64)
    return learned_sort.sort_device(
        model, hi, lo, tl if tail else None,
        return_overflow=True, **PATHS[path])


def _assert_is_reference(keys: np.ndarray, out) -> None:
    want = full_key_ref.full_key_sort(torch.from_numpy(keys))
    assert out[3].dtype == torch.int32
    for g, w in zip(out[:4], want):
        assert torch.equal(g, w)
    np.testing.assert_array_equal(out[3].numpy(), _lexsort(keys))


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", ["skewed", "uniform"])
def test_each_path_gives_the_reference(kind, n, path):
    keys = _keys(kind, n, seed=n)
    out = _sort(keys, path)
    assert out[4] == (path == "fallback")
    _assert_is_reference(keys, out)


@pytest.mark.parametrize("n", [1 << 12, 1 << 16])
def test_row_path_orders_8_byte_ties_inside_a_row(n):
    keys = _keys("uniform", n, seed=7)
    keys[1:400:3, :8] = keys[0, :8]  # one run of 8-byte ties, other tails
    keys[500:520] = keys[9]  # and equal whole keys inside it
    keys[500:520, :8] = keys[0, :8]
    out = _sort(keys, "rows")
    assert not out[4]
    _assert_is_reference(keys, out)
    # the 8-byte answer alone leaves the run in input order: not the reference
    eight = _sort(keys, "rows", tail=False)
    assert not torch.equal(eight[2], out[3])


@pytest.mark.parametrize("path", PATHS)
def test_equal_whole_keys_keep_input_order(path):
    rng = np.random.default_rng(3)
    distinct = _keys("skewed", 64, seed=3)
    keys = distinct[rng.integers(0, 64, 1 << 12)]
    out = _sort(keys, path, model=trmi.fit(distinct, n_leaf=16))
    assert out[4] == (path == "fallback")
    _assert_is_reference(keys, out)
    k = keys[out[3].numpy()]
    same = (k[1:] == k[:-1]).all(1)
    assert same.sum() > 3000 and (np.diff(out[3].numpy())[same] > 0).all()


@pytest.mark.parametrize("width", [3, 8, 9, 10, 12])
def test_key_widths_words_and_order(width):
    keys = _keys("skewed", 1 << 12, width=width, seed=width)
    t = torch.from_numpy(keys)
    ops.reset_launches()
    hi, lo, tail = ops.encode_full_keys(t)
    assert ops.encode_full_keys.launches == 0  # the plain twin, on the CPU
    want = full_key_ref.words(t)
    for g, w in zip((hi, lo, tail), want):
        assert torch.equal(g, w)
    assert all(torch.equal(g, w) for g, w in zip((hi, lo), encoding.encode(t)))
    np.testing.assert_array_equal(encoding.tail_np(keys), tail.numpy())
    assert torch.equal(encoding.tail_bytes(tail, width), t[:, 8:])
    if width <= 8:
        assert not tail.any()
    _assert_is_reference(keys, _sort(keys, "rows"))


def test_a_key_wider_than_12_bytes_raises():
    keys = _keys("uniform", 16, width=13)
    for f in (ops.encode_full_keys, encoding.encode_tail, full_key_ref.words):
        with pytest.raises(ValueError):
            f(torch.from_numpy(keys))
    with pytest.raises(ValueError):
        encoding.tail_np(keys)
    with pytest.raises(ValueError):
        encoding.tail_bytes(torch.zeros(16, dtype=torch.int64), 13)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("path", PATHS)
def test_without_tail_the_call_is_todays(path):
    """A call without tail words runs the ops it ran before they existed
    and gives the JAX chain's answer bit for bit; one given them runs the
    same ops first, then the tie pass alone: a scan and one stable sort."""
    keys = _keys("skewed", 1 << 12, seed=11)
    hi, lo, tail = ops.encode_full_keys(torch.from_numpy(keys))
    jmodel = jrmi.fit(keys, n_leaf=64)
    model = trmi.params_from_numpy(jmodel)
    kw = dict(return_overflow=True, **PATHS[path])
    with _Ops() as plain:
        *got, overflow = learned_sort.sort_device(model, hi, lo, **kw)
    with _Ops() as full:
        learned_sort.sort_device(model, hi, lo, tail, **kw)
    assert overflow == (path == "fallback")
    assert full.ops[: len(plain.ops)] == plain.ops
    extra = full.ops[len(plain.ops):]
    assert extra.count("aten.cumsum.default") == 1
    assert sum(op.startswith("aten.sort") for op in extra) == 1
    want = jls.sort_device(jmodel, jnp.asarray(hi.numpy().astype(np.uint32)),
                           jnp.asarray(lo.numpy().astype(np.uint32)),
                           use_kernels=False, **PATHS[path])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))


@pytest.mark.parametrize("n", [1 << 10, 1 << 14])
@pytest.mark.parametrize("kind", ["skewed", "uniform"])
def test_full_key_perm_equals_the_jax_chain(kind, n):
    keys = _keys(kind, n, seed=n + 1)
    jmodel = jrmi.fit(keys, n_leaf=64)
    hi, lo, tail = ops.encode_full_keys(torch.from_numpy(keys))
    _, _, jperm = jls.sort_device(jmodel, jnp.asarray(hi.numpy().astype(np.uint32)),
                                  jnp.asarray(lo.numpy().astype(np.uint32)),
                                  use_kernels=False)
    want = jexec._memcmp_touchup(keys, np.asarray(jperm).astype(np.int64))
    out = learned_sort.sort_device(trmi.params_from_numpy(jmodel), hi, lo, tail)
    np.testing.assert_array_equal(out[3].numpy(), want)


def test_counters_and_span():
    keys = _keys("skewed", 1 << 12, seed=5)
    learned_sort.reset_counters()
    _sort(keys, "rows")
    _sort(keys, "fallback", tail=False)
    f = learned_sort.sort_device
    assert (f.calls, f.records, f.full_key_calls, f.full_key_records) == (
        2, 2 << 12, 1, 1 << 12)
    ops.reset_launches()
    assert f.full_key_calls == f.full_key_records == 0
    cpu = [torch.profiler.ProfilerActivity.CPU]
    for tail in (True, False):
        with torch.profiler.profile(activities=cpu) as prof:
            _sort(keys, "fallback", tail=tail)
        spans = [e for e in prof.events() if e.name == "repro_torch.full_key"]
        assert len(spans) == int(tail)
        if tail:  # last, inside sort_device
            (outer,) = [e for e in prof.events() if e.name == "repro_torch.sort_device"]
            assert outer.time_range.start <= spans[0].time_range.start
            assert spans[0].time_range.end <= outer.time_range.end
            assert all(e.time_range.start <= spans[0].time_range.start
                       for e in prof.events() if e.name == "repro_torch.fallback")


@pytest.mark.parametrize("width,touchups", [(10, 0), (12, 0), (16, 1)])
def test_per_partition_chain_touches_up_only_wider_keys(monkeypatch, width,
                                                        touchups):
    keys = _keys("skewed", 3000, width=width, seed=width)
    block = RecordBlock(keys.reshape(-1).copy(),
                        np.arange(0, keys.size + 1, width, dtype=np.int64), keys)
    calls = []
    real = executor._memcmp_touchup
    monkeypatch.setattr(executor, "_memcmp_touchup",
                        lambda *a: calls.append(1) or real(*a))
    out = executor.sort_partition(trmi.fit(keys, n_leaf=64), block,
                                  device=torch.device("cpu"))
    assert len(calls) == touchups
    np.testing.assert_array_equal(out.keys, keys[_lexsort(keys)])
