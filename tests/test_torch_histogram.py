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
