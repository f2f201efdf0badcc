"""Port parity of the per-partition device chain:
``repro_torch.core.learned_sort.sort_device`` (on the CPU: the RMI and
row-sort kernels' plain versions) must return the sorted words and the
permutation of the JAX ``sort_device(use_kernels=False)`` bit for bit —
uniform, skewed, all-equal and SENTINEL-valued keys, a forced overflow,
n in {1, 3, 511, 512, 4097} — with bucket ids equal to the JAX *eager*
``rmi.predict_bucket``.  End to end, ``sort_file(executor=
"per_partition")`` writes the reference's bytes.
"""

import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import encoding as jenc  # noqa: E402
from repro.core import external as jext  # noqa: E402
from repro.core import learned_sort as jls  # noqa: E402
from repro.core import rmi as jrmi  # noqa: E402
from repro.core.format import LineFormat as JLineFormat  # noqa: E402
from repro.data import gensort, lines  # noqa: E402
from repro_torch.core import external as text  # noqa: E402
from repro_torch.core import learned_sort as tls  # noqa: E402
from repro_torch.core import rmi as trmi  # noqa: E402
from repro_torch.core.config import SortConfig  # noqa: E402
from repro_torch.core.encoding import SENTINEL  # noqa: E402
from repro_torch.core.executor import (  # noqa: E402
    PerPartitionDeviceExecutor,
    make_executor,
)
from repro_torch.core.format import LineFormat  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

SIZES = (1, 3, 511, 512, 4097)
KINDS = ("uniform", "skewed", "allequal", "sentinel")


def _case(kind: str, n: int):
    """(u32 hi, u32 lo, JAX model) for one corpus; the model is fitted on
    a sample of the keys, as the pipeline fits it."""
    if kind == "skewed":
        keys = gensort.skewed_keys(max(n, 64), seed=2)[:n]
    else:
        keys = gensort.uniform_keys(max(n, 64), seed=1)[:n]
    if kind == "allequal":
        keys = np.repeat(keys[:1], n, axis=0)
    hi, lo = jenc.encode_np(keys)
    if kind == "sentinel":
        # real records whose words are SENTINEL: they tie with padding
        # slots and must win on val (reference learned_sort.py:101-105)
        pick = np.random.default_rng(3).random(n) < 0.3
        hi[pick] = SENTINEL
        lo[pick[::-1]] = SENTINEL
    sample = gensort.uniform_keys(256, seed=4) if kind == "sentinel" else keys
    return hi, lo, jrmi.fit(sample, n_leaf=64)


def _torch_words(hi, lo):
    return (torch.from_numpy(hi.astype(np.int64)),
            torch.from_numpy(lo.astype(np.int64)))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", KINDS)
def test_sort_device_bit_equal_to_jax(kind, n):
    hi, lo, jmodel = _case(kind, n)
    want = jls.sort_device(
        jmodel, jnp.asarray(hi), jnp.asarray(lo), use_kernels=False
    )
    tmodel = trmi.params_from_numpy(jmodel)
    got = tls.sort_device(tmodel, *_torch_words(hi, lo))
    assert got[2].dtype == torch.int32
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))
    # the bucket ids of the chain equal the JAX eager prediction
    n_buckets, capacity = tls.grid_shape(n)
    assert (n_buckets, capacity) == (
        max(1, jls._next_pow2(n) // 512),
        jls._next_pow2(int(n / n_buckets * 2.0) + 1),
    )
    ids = ops.rmi_bucket(tmodel, *_torch_words(hi, lo), n_buckets)
    np.testing.assert_array_equal(
        ids.numpy(),
        np.asarray(jrmi.predict_bucket(
            jmodel, jnp.asarray(hi), jnp.asarray(lo), n_buckets
        )),
    )


@pytest.mark.parametrize("capacity_factor", [2.0, 0.25])
def test_forced_overflow_bit_equal_to_jax(capacity_factor):
    """64 buckets of ~64 uniform keys: at the default factor (capacity
    256) the fast path holds; at 0.25 (capacity 32) every bucket
    overflows and both packages answer with the stable full sort."""
    hi, lo, jmodel = _case("uniform", 4097)
    kw = dict(n_buckets=64, capacity_factor=capacity_factor)
    want = jls.sort_device(
        jmodel, jnp.asarray(hi), jnp.asarray(lo), use_kernels=False, **kw
    )
    *got, overflow = tls.sort_device(trmi.params_from_numpy(jmodel),
                                     *_torch_words(hi, lo),
                                     return_overflow=True, **kw)
    assert overflow == (capacity_factor < 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))


def test_compact_matches_reference():
    """_compact gathers each row's valid prefix in row order."""
    rng = np.random.default_rng(6)
    counts = np.array([3, 0, 4, 1], np.int32)
    rows = rng.integers(0, 100, size=(4, 4)).astype(np.int32)
    want = jls._compact(*(jnp.asarray(rows),) * 3, jnp.asarray(counts), 8)
    got = tls._compact(*(torch.from_numpy(rows),) * 3,
                       torch.from_numpy(counts), 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


_REF: dict = {}


def _reference(tmp_path_factory, fmt_kind: str):
    """(input, JAX output sha, JAX stats): the reference's host executor,
    whose bytes every executor of both packages must write."""
    if fmt_kind not in _REF:
        d = tmp_path_factory.mktemp(f"pp_{fmt_kind}")
        inp, out = str(d / "in"), str(d / "jax.out")
        if fmt_kind == "fixed":
            gensort.write_file(inp, 4_000, skewed=True, seed=3)
            fmt = None
        else:
            lines.write_lines(inp, 4_000, kind="skewed", seed=5)
            fmt = JLineFormat(max_key_bytes=16)
        st = jext.sort_file(inp, out, config=jext.SortConfig(
            memory_budget_bytes=1 << 20, n_partitions=16, fmt=fmt,
        ))
        _REF[fmt_kind] = (inp, hashlib.sha256(open(out, "rb").read())
                          .hexdigest(), st)
    return _REF[fmt_kind]


@pytest.mark.parametrize("n_readers", [1, 3])
@pytest.mark.parametrize("fmt_kind", ["fixed", "line"])
def test_per_partition_sort_file_bytes_equal_jax(
    tmp_path_factory, tmp_path, fmt_kind, n_readers
):
    inp, jsha, jstats = _reference(tmp_path_factory, fmt_kind)
    out = str(tmp_path / "torch.out")
    stats = text.sort_file(inp, out, config=SortConfig(
        memory_budget_bytes=1 << 20, n_partitions=16, device="cpu",
        executor="per_partition", n_readers=n_readers,
        fmt=LineFormat(max_key_bytes=16) if fmt_kind == "line" else None,
    ))
    assert hashlib.sha256(open(out, "rb").read()).hexdigest() == jsha
    assert stats.executor == "per_partition"
    assert stats.partition_counts == jstats.partition_counts
    assert stats.planner_decision == jstats.planner_decision
    # one dispatch per partition of two or more records
    assert stats.device_dispatches == sum(
        c > 1 for c in stats.partition_counts
    )


@pytest.mark.parametrize("n,fallbacks", [(1 << 14, 0), (12_000, 1)])
def test_per_partition_fallback_only_when_padded(tmp_path, n, fallbacks):
    """One partition of a power-of-two count takes the chain's own
    answer (rows compacted, no fallback); any other count is padded with
    SENTINEL words that all land in the last bucket, overflow it, and
    take the stable fallback, as in the reference.  Both write the JAX
    host executor's bytes."""
    inp, out = str(tmp_path / "in"), str(tmp_path / "jax.out")
    gensort.write_file(inp, n, seed=9)
    jext.sort_file(inp, out, config=jext.SortConfig(n_partitions=1))
    jsha = hashlib.sha256(open(out, "rb").read()).hexdigest()
    stats = text.sort_file(inp, out, config=SortConfig(
        n_partitions=1, device="cpu", executor="per_partition",
    ))
    assert hashlib.sha256(open(out, "rb").read()).hexdigest() == jsha
    assert (stats.device_dispatches, stats.fallbacks) == (1, fallbacks)


def test_per_partition_executor_defaults_to_the_card():
    """Besides the default: a duplicate flood takes the chain's stable
    fallback, counted once a partition, with the host's bytes."""
    from repro_torch.core.executor import HostSortExecutor
    from repro_torch.core.format import GENSORT

    model = trmi.fit(gensort.uniform_keys(256, seed=1), n_leaf=16)
    ex = make_executor(model, executor="per_partition", device="cpu")
    assert isinstance(ex, PerPartitionDeviceExecutor)
    assert ex.device.type == "cpu" and ex.parallel_safe
    recs = gensort.make_records(4097, seed=2)
    recs[:, :6] = 65  # 4,097 keys in one bucket: overflow
    blocks = [GENSORT.parse_blob(recs.tobytes()),
              GENSORT.parse_blob(gensort.make_records(300, seed=3).tobytes())]
    got = [b.tobytes() for _, b in ex.sort_iter(enumerate(blocks))]
    host = HostSortExecutor(model).sort_iter(enumerate(blocks))
    assert got == [b.tobytes() for _, b in host]
    assert (ex.fallbacks, ex.dispatches) == (1, 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_executor(model, executor="per_partition")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PerPartitionDeviceExecutor(model)
