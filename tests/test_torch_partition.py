"""Port parity: ``repro_torch.core.partition`` and the comparison oracle of
``repro_torch.core.learned_sort`` against the JAX package's, including
``bucket_matrix``'s dropped overflow slot and ``valid`` mask."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.core import encoding as jenc  # noqa: E402
from repro.core import learned_sort as jls  # noqa: E402
from repro.core import partition as jpart  # noqa: E402
from repro.core import rmi as jrmi  # noqa: E402
from repro.data import gensort  # noqa: E402
from repro_torch.core import learned_sort as tls  # noqa: E402
from repro_torch.core import partition as tpart  # noqa: E402
from repro_torch.core import rmi as trmi  # noqa: E402


@pytest.mark.parametrize(
    "n,n_buckets,capacity",
    [(1, 1, 8), (500, 8, 128), (500, 8, 16), (4096, 64, 32), (999, 7, 1)],
)
def test_bucket_matrix_equal_jax(n, n_buckets, capacity):
    """Same grid, mask and counts — also when buckets overflow their
    capacity and records fall into the dropped extra slot."""
    rng = np.random.default_rng(n + capacity)
    ids = rng.integers(0, n_buckets, size=n).astype(np.int32)
    gj, vj, cj = jpart.bucket_matrix(jnp.asarray(ids), n_buckets, capacity)
    gt, vt, ct = tpart.bucket_matrix(torch.from_numpy(ids), n_buckets, capacity)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    # invalid slots carry 0 in both; valid slots the same source row
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    perm_j, starts_j, counts_j = jpart.bucket_offsets(jnp.asarray(ids), n_buckets)
    perm_t, starts_t, counts_t = tpart.bucket_offsets(torch.from_numpy(ids), n_buckets)
    np.testing.assert_array_equal(perm_t.numpy(), np.asarray(perm_j))
    np.testing.assert_array_equal(starts_t.numpy(), np.asarray(starts_j))
    np.testing.assert_array_equal(counts_t.numpy(), np.asarray(counts_j))
    # the grid built from the counts alone is the reference's grid too
    ids_t = torch.from_numpy(ids)
    gg, vg = tpart.bucket_grid(
        ids_t, tpart.bucket_histogram(ids_t, n_buckets), capacity
    )
    np.testing.assert_array_equal(vg.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(gg.numpy(), np.asarray(gj))


def test_routing_helpers_equal_jax():
    for n, d, f in [(1, 1, 1.0), (1000, 8, 2.0), (1024, 4, 1.0), (7, 3, 1.5)]:
        assert tpart.route_capacity(n, d, f) == jpart.route_capacity(n, d, f)
    counts = np.array([5, 0, 12, 7])
    assert tpart.partition_size_stats(counts) == jpart.partition_size_stats(counts)
    ids = np.random.default_rng(1).integers(0, 10, 300).astype(np.int32)
    np.testing.assert_array_equal(
        tpart.take_by_bucket(torch.from_numpy(ids)).numpy(),
        np.asarray(jpart.take_by_bucket(jnp.asarray(ids))),
    )
    np.testing.assert_array_equal(
        tpart.bucket_histogram(torch.from_numpy(ids), 10).numpy(),
        np.asarray(jpart.bucket_histogram(jnp.asarray(ids), 10)),
    )


def _cell_ids(kind: str, rng) -> tuple[np.ndarray, int]:
    """(ids, n_buckets) in the patterns the benchmark's cells count, cut
    to the CPU: the router's 4 destinations, and 5 with its discard
    bucket; a rank's received slots at 2^20 bins, the second half of
    each sender's quarter one run of the last bin (its SENTINEL
    padding); ids with a spike of a few hot bins, in random order."""
    if kind in ("route", "route_discard"):
        n_buckets = 4 if kind == "route" else 5
        return rng.integers(0, n_buckets, 100_000, dtype=np.int32), n_buckets
    if kind == "padding":
        n_buckets = 1 << 20
        ids = rng.integers(0, n_buckets, 1 << 21, dtype=np.int32)
        ids.reshape(4, -1)[:, 1 << 18 :] = n_buckets - 1
        return ids, n_buckets
    n_buckets = 1 << 17
    ids = rng.integers(0, n_buckets, 1 << 20, dtype=np.int32)
    spike = rng.random(ids.size) < 0.5
    ids[spike] = rng.choice(rng.integers(0, n_buckets, 9), size=int(spike.sum()))
    return ids, n_buckets


@pytest.mark.parametrize("kind", ["route", "route_discard", "padding", "spike"])
def test_bucket_histogram_counts_the_cells_ids(kind):
    """The glue's count equals ``np.bincount`` on every id pattern the
    cells give it, int32, one count a bin."""
    ids, n_buckets = _cell_ids(kind, np.random.default_rng(len(kind)))
    got = tpart.bucket_histogram(torch.from_numpy(ids), n_buckets)
    assert got.dtype == torch.int32 and got.shape == (n_buckets,)
    np.testing.assert_array_equal(
        got.numpy(), np.bincount(ids, minlength=n_buckets)
    )


def test_bucket_histogram_on_meta_gives_the_shape():
    """The dry run traces the MoE dispatch on ``meta`` tensors: the count
    has the shape and dtype it has on a device, and nothing launches."""
    ids = torch.empty(4096, dtype=torch.int32, device="meta")
    got = tpart.bucket_histogram(ids, 8)
    assert (got.device.type, got.dtype, tuple(got.shape)) == ("meta", torch.int32, (8,))


@pytest.mark.parametrize("skewed", [False, True])
def test_radix_and_model_buckets_equal_jax(skewed):
    keys = (
        gensort.skewed_keys(3000, seed=2) if skewed
        else gensort.uniform_keys(3000, seed=2)
    )
    hi, lo = jenc.encode_np(keys)
    hi_t = torch.from_numpy(hi.astype(np.int64))
    lo_t = torch.from_numpy(lo.astype(np.int64))
    model = jrmi.fit(keys, n_leaf=128)
    args = (int(hi.min()), 0, np.float32(1.0 / 2**32))
    want = np.asarray(
        jpart.radix_bucket(jnp.asarray(hi), jnp.asarray(lo), 37, *args)
    )
    got = tpart.radix_bucket(
        hi_t, lo_t, 37, torch.tensor(args[0]), torch.tensor(args[1]),
        torch.tensor(args[2]),
    )
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tpart.radix_bucket_np(hi, lo, 37), jpart.radix_bucket_np(hi, lo, 37)
    )
    np.testing.assert_array_equal(
        tpart.model_bucket_np(trmi.params_from_numpy(model), hi, lo, 64),
        jpart.model_bucket_np(model, hi, lo, 64),
    )


def _oracle_keys(kind: str) -> np.ndarray:
    """Keys for the oracle's parity: the skewed gensort corpus; the same
    with a tail of all-0xFF rows (SENTINEL in both words, as callers pad);
    one key repeated; keys drawn with repeats from a pool whose ``hi``
    straddles ``2**31`` (first byte 0x7F or 0x80, both edge words
    included)."""
    if kind == "skewed":
        return gensort.skewed_keys(5000, seed=4)  # duplicate-heavy prefixes
    if kind == "sentinel_tail":
        keys = gensort.skewed_keys(3000, seed=5)
        return np.concatenate([keys, np.full((1096, keys.shape[1]), 0xFF, np.uint8)])
    if kind == "allequal":
        return np.repeat(gensort.uniform_keys(1, seed=6), 4096, axis=0)
    rng = np.random.default_rng(7)
    pool = rng.integers(0, 256, size=(500, 10), dtype=np.uint8)
    pool[:, 0] = rng.choice([0x7F, 0x80], size=500)
    pool[0, :4], pool[1, :4] = (0x7F, 0xFF, 0xFF, 0xFF), (0x80, 0, 0, 0)
    return pool[rng.integers(0, 500, size=4000)]


@pytest.mark.parametrize("kind", ["skewed", "sentinel_tail", "allequal", "straddle"])
def test_sort_oracle_and_sort_host_equal_jax(kind):
    keys = _oracle_keys(kind)
    hi, lo = jenc.encode_np(keys)
    hj, lj, pj = jls.sort_oracle(jnp.asarray(hi), jnp.asarray(lo))
    ht, lt, pt = tls.sort_oracle(
        torch.from_numpy(hi.astype(np.int64)), torch.from_numpy(lo.astype(np.int64))
    )
    assert pt.dtype == torch.int32
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj).astype(np.int64))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj).astype(np.int64))
    model = jrmi.fit(keys, n_leaf=256)
    np.testing.assert_array_equal(
        tls.sort_host(trmi.params_from_numpy(model), keys),
        jls.sort_host(model, keys),
    )


class _AtenOps(TorchDispatchMode):
    """Records every aten op dispatched inside it, with its kwargs."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append((func, kwargs or {}))
        return func(*args, **(kwargs or {}))


def test_sort_oracle_sorts_once_and_gathers_nothing():
    """The oracle's words come from its one stable sort's own sorted keys:
    exactly one ``aten.sort``, stable, and no gather through the
    permutation (``index``, ``gather``, ``index_select``, ``take``)."""
    hi, lo = jenc.encode_np(gensort.skewed_keys(2000, seed=8))
    with _AtenOps() as seen:
        tls.sort_oracle(
            torch.from_numpy(hi.astype(np.int64)),
            torch.from_numpy(lo.astype(np.int64)),
        )
    packets = [func.overloadpacket for func, _ in seen.ops]
    sorts = [(f, kw) for f, kw in seen.ops if f.overloadpacket is torch.ops.aten.sort]
    assert len(sorts) == 1 and sorts[0][1].get("stable") is True, sorts
    gathers = {
        torch.ops.aten.index, torch.ops.aten.gather,
        torch.ops.aten.index_select, torch.ops.aten.take,
    }
    assert not [p for p in packets if p in gathers], packets
