"""Port parity of the bucket histogram: the port's ``ops.bucket_histogram``
(its plain version on the CPU) must equal the JAX package's wrapper, which
runs the Pallas kernel in interpret mode here, bit for bit — over the
reference's kernel sweep, with ids outside ``[0, n_buckets)`` mixed in
(they never count), and on all-equal ids.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro_torch.kernels import histogram, ops, ref  # noqa: E402


def _both(ids: np.ndarray, n_buckets: int):
    got = ops.bucket_histogram(torch.from_numpy(ids), n_buckets)
    want = np.asarray(jops.bucket_histogram(jnp.asarray(ids), n_buckets))
    assert got.dtype == torch.int32 and got.shape == (n_buckets,)
    return got.numpy(), want


@pytest.mark.parametrize("n", [512, 4096, 7777])
@pytest.mark.parametrize("n_buckets", [8, 128, 1000])
def test_histogram_equals_jax(n, n_buckets):
    rng = np.random.default_rng(n * n_buckets)
    ids = rng.integers(0, n_buckets, size=n, dtype=np.int32)
    got, want = _both(ids, n_buckets)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(jref.histogram_ref(jnp.asarray(ids), n_buckets))
    )
    np.testing.assert_array_equal(got, ref.histogram_ref(ids, n_buckets).numpy())
    assert int(got.sum()) == n


@pytest.mark.parametrize("n_buckets", [8, 1000])
def test_out_of_range_ids_never_count(n_buckets):
    """-1 (the reference's padding), other negatives and ids >= n_buckets
    are dropped by the reference's wrapper + kernel, and by the port."""
    rng = np.random.default_rng(n_buckets)
    ids = rng.integers(0, n_buckets, size=3000, dtype=np.int32)
    bad = rng.choice(3000, size=700, replace=False)
    ids[bad] = rng.choice(
        np.array([-1, -7, n_buckets, n_buckets + 5, 2**31 - 1], np.int32),
        size=700,
    )
    got, want = _both(ids, n_buckets)
    np.testing.assert_array_equal(got, want)
    assert int(got.sum()) == 3000 - 700
    np.testing.assert_array_equal(got, ref.histogram_ref(ids, n_buckets).numpy())


@pytest.mark.parametrize("value", [0, 3, 127])
def test_all_equal_ids(value):
    ids = np.full(4096, value, dtype=np.int32)
    got, want = _both(ids, 128)
    np.testing.assert_array_equal(got, want)
    assert int(got[value]) == 4096 and int(got.sum()) == 4096


def test_plain_version_is_the_cpu_path():
    ids = torch.tensor([0, 1, 1, -1, 9], dtype=torch.int32)
    np.testing.assert_array_equal(
        histogram.histogram_plain(ids, 4).numpy(), [1, 2, 0, 0]
    )
    with pytest.raises(ValueError):
        ops.bucket_histogram(torch.empty(4, dtype=torch.int32, device="meta"), 4)


H100 = 58_112  # bins a block's 227 KB hold


@pytest.mark.parametrize(
    "n_buckets,strategy,cluster",
    [(1, "shared", 8), (8, "shared", 8), (8192, "shared", 8),
     (58_112, "shared", 8), (58_113, "split", 2), (116_224, "split", 2),
     (116_225, "global", 0), (464_896, "global", 0), (464_897, "global", 0),
     (1 << 20, "global", 0)],
)
def test_launch_geometry_gives_every_bin_one_owner(n_buckets, strategy, cluster):
    """On an H100's limit every bin has exactly one owning block in a
    cluster (the one that adds into it, split, or sums and flushes it,
    shared), no block holds more bins than its shared memory, and the
    strategies split at 58,112 and 2 x 58,112 bins."""
    geo = histogram.launch_geometry(n_buckets, H100)
    assert (geo.strategy, geo.cluster) == (strategy, cluster)
    if strategy == "global":
        assert n_buckets > 2 * H100
        return
    assert 1 <= geo.block_bins <= H100
    held = n_buckets if strategy == "shared" else geo.slice
    assert geo.block_bins == held
    owner = np.arange(n_buckets) // geo.slice
    assert owner.max() < geo.cluster
    owned = np.bincount(owner, minlength=geo.cluster)
    assert owned.sum() == n_buckets and owned.max() <= geo.slice
    # block r's slice [r * slice, (r + 1) * slice) is the bins it owns
    for r in range(geo.cluster):
        lo, hi = r * geo.slice, min((r + 1) * geo.slice, n_buckets)
        assert (owner[lo:hi] == r).all()


def test_launch_geometry_rejects_no_bins():
    with pytest.raises(ValueError):
        histogram.launch_geometry(0, H100)


def _replay(ids, n_buckets, geo, clusters):
    """``csrc/histogram.cu`` in NumPy: warp w of the grid takes steps
    w, w + W, ... of 32 lanes x IDS_PER_LANE ids (lane l, slot r reads id
    base + 32 r + l; out-of-range ids and ids past the end read as -1).  A
    step whose ids are all one in-range id adds them at once; other
    steps add each in-range id: into the block's private histogram
    (shared), the owner's slice (split) or the output (global).  Then a
    shared cluster's block r sums slice r over the cluster's blocks and
    flushes it, and a split cluster's block flushes its own slice.
    Returns the counts and the atomics issued (adds, flushes)."""
    step = 32 * histogram.IDS_PER_LANE[geo.strategy]
    c = max(geo.cluster, 1)
    warps = clusters * c * 8  # 256 threads a block
    n_steps = -(-ids.size // step)
    padded = np.full(max(n_steps, 1) * step, -1, np.int64)
    padded[: ids.size] = ids
    padded[(padded < 0) | (padded >= n_buckets)] = -1
    out = np.zeros(n_buckets, np.int64)
    smem = np.zeros((clusters, c, max(geo.block_bins, 1)), np.int64)
    adds = 0

    def add(warp, bin_, count):
        block = warp // 8
        if geo.strategy == "global":
            out[bin_] += count
        elif geo.strategy == "shared":
            smem[block // c, block % c, bin_] += count
        else:
            owner, local = divmod(int(bin_), geo.slice)
            assert owner < c and local < geo.block_bins
            smem[block // c, owner, local] += count

    for s in range(n_steps):
        warp, v = s % warps, padded[s * step : (s + 1) * step]
        if (v == v[0]).all() and v[0] >= 0:
            add(warp, v[0], step)
            adds += 1
            continue
        for b in v[v >= 0]:
            add(warp, b, 1)
            adds += 1
    flushes = 0
    for cl in range(clusters if geo.strategy != "global" else 0):
        for r in range(c):
            lo, hi = r * geo.slice, min((r + 1) * geo.slice, n_buckets)
            if geo.strategy == "shared":
                part = smem[cl, :, lo:hi].sum(axis=0)
            else:
                part = smem[cl, r, : hi - lo]
            out[lo:hi] += part
            flushes += int((part != 0).sum())
    return out.astype(np.int32), adds, flushes


# (n_buckets, max_bins): limits small enough to reach every strategy at
# small bin counts -- shared, split, global
REPLAY_CASES = [
    (1, H100), (8, H100), (1000, H100), (64, 64), (65, 64), (100, 64),
    (128, 64), (129, 64), (1000, 64),
]


@pytest.mark.parametrize("kind", ["uniform", "equal", "out_of_range", "skewed"])
@pytest.mark.parametrize("n_buckets,max_bins", REPLAY_CASES)
def test_replay_equals_jax(n_buckets, max_bins, kind):
    """The kernel's ownership and its all-equal steps count what the JAX
    ``histogram_pallas`` (interpret mode) counts; all-equal ids take one
    add a full warp step, and the flush is never more atomics than ids."""
    rng = np.random.default_rng(n_buckets)
    n = 5000
    ids = rng.integers(0, n_buckets, size=n, dtype=np.int32)
    if kind == "equal":
        ids[:] = n_buckets // 3
    elif kind == "out_of_range":
        bad = rng.choice(n, size=n // 5, replace=False)
        ids[bad] = rng.choice(
            np.array([-1, -9, n_buckets, 2**31 - 1], np.int32), size=bad.size
        )
    elif kind == "skewed":
        ids = np.minimum(rng.zipf(1.5, size=n) - 1, n_buckets - 1).astype(np.int32)
    geo = histogram.launch_geometry(n_buckets, max_bins)
    got, adds, flushes = _replay(ids, n_buckets, geo, clusters=2)
    _, want = _both(ids, n_buckets)
    np.testing.assert_array_equal(got, want)
    step = 32 * histogram.IDS_PER_LANE[geo.strategy]
    if kind == "equal":
        assert adds == n // step + n % step
    assert flushes <= n
