"""Port parity: ``repro_torch.core.encoding`` against ``repro.core.encoding``
(bit-equal words and features on the ``test_encode_kernel_sweep`` grid;
the base-95 oracle equal, ``packed_key`` in its order and
``unpack_key`` its exact inverse)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import encoding as jenc  # noqa: E402
from repro_torch.core import encoding as tenc  # noqa: E402


def _keys(n, width, seed):
    return np.random.default_rng(seed).integers(
        0, 256, size=(n, width), dtype=np.uint8
    )


@pytest.mark.parametrize("n", [256, 1024, 5000, 12345])
@pytest.mark.parametrize("width", [3, 8, 10, 16])
def test_encode_bit_equal(n, width):
    keys = _keys(n, width, n + width)
    hi_j, lo_j = jenc.encode(jnp.asarray(keys))
    hi_t, lo_t = tenc.encode(torch.from_numpy(keys))
    assert hi_t.dtype == torch.int64 and lo_t.dtype == torch.int64
    np.testing.assert_array_equal(hi_t.numpy(), np.asarray(hi_j).astype(np.int64))
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j).astype(np.int64))
    hi_n, lo_n = tenc.encode_np(keys)
    hi_r, lo_r = jenc.encode_np(keys)
    assert hi_n.dtype == hi_r.dtype == np.uint32
    np.testing.assert_array_equal(hi_n, hi_r)
    np.testing.assert_array_equal(lo_n, lo_r)


@pytest.mark.parametrize("n", [256, 5000])
@pytest.mark.parametrize("width", [8, 10, 16])
def test_feature_f32_bit_equal(n, width):
    """Borrow subtract on int64-carried words == the reference's u32
    wrap, including keys below the minimum (mapped to 0)."""
    keys = _keys(n, width, 7 * n + width)
    hi, lo = jenc.encode_np(keys)
    # a minimum taken from inside the data, so some keys fall below it
    # and many borrow on the low word
    i = n // 3
    min_hi, min_lo = hi[i], lo[i]
    span = (int(hi.max()) - int(min_hi)) * 4294967296.0 + 1.0
    inv = np.float32(1.0 / span)
    x_j = jenc.feature_f32(
        jnp.asarray(hi), jnp.asarray(lo), min_hi, min_lo, inv
    )
    x_t = tenc.feature_f32(
        torch.from_numpy(hi.astype(np.int64)),
        torch.from_numpy(lo.astype(np.int64)),
        torch.tensor(int(min_hi)),
        torch.tensor(int(min_lo)),
        torch.tensor(inv),
    )
    assert x_t.dtype == torch.float32
    np.testing.assert_array_equal(
        x_t.numpy().view(np.uint32), np.asarray(x_j).view(np.uint32)
    )
    np.testing.assert_array_equal(
        tenc.feature_f64_np(hi, lo, int(min_hi), int(min_lo), float(inv)),
        jenc.feature_f64_np(hi, lo, int(min_hi), int(min_lo), float(inv)),
    )


def test_packed_key_keeps_unsigned_order():
    rng = np.random.default_rng(3)
    hi = rng.integers(0, 2**32, size=4000, dtype=np.uint64)
    lo = rng.integers(0, 2**32, size=4000, dtype=np.uint64)
    hi[:50] = 0xFFFFFFFF  # sentinel words sort last
    lo[:50] = 0xFFFFFFFF
    hi[50:100] = 0
    key = tenc.packed_key(
        torch.from_numpy(hi.astype(np.int64)), torch.from_numpy(lo.astype(np.int64))
    )
    got = torch.sort(key, stable=True).indices.numpy()
    np.testing.assert_array_equal(got, np.lexsort((lo, hi)))


def test_unpack_key_inverts_packed_key():
    """``unpack_key(packed_key(hi, lo))`` is ``(hi, lo)`` bit for bit, on
    seeded words and on every edge word in either place (0, ``2**31 -
    1``, ``2**31``, ``2**32 - 1``, SENTINEL), with ``lo`` written into
    the packed key's own buffer."""
    edges = np.array([0, 2**31 - 1, 2**31, 2**32 - 1, tenc.SENTINEL], np.int64)
    rng = np.random.default_rng(11)
    seeded = rng.integers(0, 2**32, size=4000, dtype=np.int64)
    hi = np.concatenate([np.repeat(edges, edges.size), seeded, edges, seeded[:5]])
    lo = np.concatenate(
        [np.tile(edges, edges.size), rng.permutation(seeded), seeded[-5:], edges]
    )
    v = tenc.packed_key(torch.from_numpy(hi), torch.from_numpy(lo))
    ptr = v.data_ptr()
    got_hi, got_lo = tenc.unpack_key(v)
    assert got_hi.dtype == got_lo.dtype == torch.int64
    np.testing.assert_array_equal(got_hi.numpy(), hi)
    np.testing.assert_array_equal(got_lo.numpy(), lo)
    assert got_lo.data_ptr() == ptr


def test_ascii_digits_and_constants():
    v = np.array([0, 7, 4_242_424_242, 9_999_999_999], dtype=np.int64)
    np.testing.assert_array_equal(
        tenc.ascii_digits(v, 10), jenc.ascii_digits(v, 10)
    )
    with pytest.raises(ValueError):
        tenc.ascii_digits(np.array([10**10]), 10)
    assert tenc.ENCODED_BYTES == jenc.ENCODED_BYTES
    assert tenc.SENTINEL == int(jenc.SENTINEL)


@pytest.mark.parametrize("alphabet", [(0, 256), (32, 127), (65, 68)])
def test_base95_oracle_equal_and_packed_key_in_its_order(alphabet):
    """``encode_base95_u64`` equals the reference's on seeded keys of 1 to
    12 bytes (control codes clamped, short keys zero-padded).  On
    printable keys of 8 bytes or more (the paper's ASCII records)
    ``packed_key(hi, lo)`` orders as the oracle does on the same 8 bytes: the oracle over 9
    bytes, divided by 95, is non-decreasing in ``packed_key`` order and
    equal exactly where ``packed_key`` ties (a 3-letter alphabet makes
    ties)."""
    rng = np.random.default_rng(alphabet[0] + alphabet[1])
    keys = [bytes(rng.integers(*alphabet, size=int(rng.integers(1, 13)), dtype=np.uint8))
            for _ in range(300)]
    for length in (8, 9, 10):
        assert ([tenc.encode_base95_u64(k, length) for k in keys]
                == [jenc.encode_base95_u64(k, length) for k in keys])
    if alphabet[0] < 32:
        return
    keys = [k for k in keys if len(k) >= 8]  # 8 real bytes: no padding to tie a space
    rows = np.stack([np.frombuffer(k.ljust(10, b"\0")[:10], np.uint8) for k in keys])
    hi, lo = tenc.encode(torch.from_numpy(rows))
    packed = tenc.packed_key(hi, lo)
    order = torch.sort(packed, stable=True).indices.tolist()
    b95 = [tenc.encode_base95_u64(keys[i]) // 95 for i in order]
    pk = packed[order].tolist()
    for a in range(len(order) - 1):
        assert b95[a] <= b95[a + 1]
        assert (b95[a] == b95[a + 1]) == (pk[a] == pk[a + 1])
