"""Port parity: ``repro_torch.core.rmi`` against ``repro.core.rmi``.

The reference has two answers for bucket ids on the CPU: eager
``rmi.predict_bucket`` rounds every float step, while under ``jit``
XLA:CPU contracts ``a * b + c`` into a fused multiply-add (and so does
the Pallas kernel in interpret mode).  The port rounds every step, so it
is held bit-equal to the EAGER function; against the jitted one it must
agree exactly at coarse bucket counts and on all but a sliver of ids at
``Q_RES = 2**20`` buckets, where a contracted root can pick the
neighbouring leaf.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import encoding as jenc  # noqa: E402
from repro.core import rmi as jrmi  # noqa: E402
from repro.data import gensort  # noqa: E402
from repro_torch.core import encoding as tenc  # noqa: E402
from repro_torch.core import rmi as trmi  # noqa: E402

Q_RES = 1 << 20


def _keys(n, skewed, seed):
    return (
        gensort.skewed_keys(n, seed=seed) if skewed
        else gensort.uniform_keys(n, seed=seed)
    )


def _words(keys):
    hi, lo = jenc.encode_np(keys)
    return (
        (jnp.asarray(hi), jnp.asarray(lo)),
        (torch.from_numpy(hi.astype(np.int64)), torch.from_numpy(lo.astype(np.int64))),
    )


@pytest.mark.parametrize("n_leaf", [64, 1024])
@pytest.mark.parametrize("skewed", [False, True])
def test_fit_equals_reference(n_leaf, skewed):
    keys = _keys(6000, skewed, 11)
    ref = jrmi.fit(keys, n_leaf=n_leaf)
    got = trmi.fit(keys, n_leaf=n_leaf)
    assert got.n_leaf == ref.n_leaf == n_leaf
    for f in dataclasses.fields(jrmi.RMIParams):
        want = np.asarray(getattr(ref, f.name))
        have = getattr(got, f.name).numpy()
        np.testing.assert_array_equal(have, want.astype(have.dtype), f.name)
    # the JAX model carried over is the port's model, field for field
    carried = trmi.params_from_numpy(ref)
    for f in dataclasses.fields(trmi.RMIParams):
        a, b = getattr(carried, f.name), getattr(got, f.name)
        assert a.dtype == b.dtype, f.name
        assert torch.equal(a, b), f.name


def test_params_round_trip():
    model = trmi.fit(gensort.uniform_keys(3000, seed=2), n_leaf=128)
    back = trmi.params_from_numpy(trmi.to_numpy(model))
    for f in dataclasses.fields(trmi.RMIParams):
        assert torch.equal(getattr(back, f.name), getattr(model, f.name))
    np_model = trmi.to_numpy(model)
    assert np_model.leaf_min_hi.dtype == np.uint32
    assert np_model.inv_range.dtype == np.float32
    assert model.ftable().shape == (128, 5)
    assert model.utable().dtype == torch.int64


@pytest.mark.parametrize("n_buckets", [16, 256, Q_RES])
@pytest.mark.parametrize("n_leaf", [64, 1024])
@pytest.mark.parametrize("skewed", [False, True])
def test_predict_bucket_bit_equal_to_eager(n_buckets, n_leaf, skewed):
    n = 4096
    keys = _keys(n, skewed, n + n_leaf)
    model = jrmi.fit(keys[: n // 2], n_leaf=n_leaf)
    (hi_j, lo_j), (hi_t, lo_t) = _words(keys)
    want = np.asarray(jrmi.predict_bucket(model, hi_j, lo_j, n_buckets))
    params = trmi.params_from_numpy(model)
    got = trmi.predict_bucket(params, hi_t, lo_t, n_buckets)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    cdf_j = np.asarray(jrmi.predict_cdf(model, hi_j, lo_j))
    cdf_t = trmi.predict_cdf(params, hi_t, lo_t).numpy()
    np.testing.assert_array_equal(cdf_t.view(np.uint32), cdf_j.view(np.uint32))
    # the host twin is a copy: identical to the reference's
    hi_n, lo_n = jenc.encode_np(keys)
    np.testing.assert_array_equal(
        trmi.predict_bucket_np(params, hi_n, lo_n, n_buckets),
        jrmi.predict_bucket_np(model, hi_n, lo_n, n_buckets),
    )


@pytest.mark.parametrize("n_buckets", [16, 256, Q_RES])
@pytest.mark.parametrize("skewed", [False, True])
def test_against_contracted_reference(n_buckets, skewed):
    """XLA:CPU's jitted answer (FMA-contracted) at 200,000 keys.

    Tolerances at ``Q_RES``, set from measurement over seeds 0-5: on
    uniform keys a contracted root now and then picks the neighbouring
    leaf (6-13 ids, by up to 154 buckets: at most 0.1% of ids); on the
    skewed keys the dense spikes put many keys at rounding edges of
    their leaf line, so 539-785 ids (0.27-0.39%) move, each by exactly
    one bucket (at most 1% of ids, |diff| <= 1)."""
    n = 200_000
    keys = _keys(n, skewed, 5)
    model = jrmi.fit(keys[: n // 2], n_leaf=1024)
    (hi_j, lo_j), (hi_t, lo_t) = _words(keys)
    jitted = jax.jit(jrmi.predict_bucket, static_argnums=3)
    want = np.asarray(jitted(model, hi_j, lo_j, n_buckets)).astype(np.int64)
    got = trmi.predict_bucket(
        trmi.params_from_numpy(model), hi_t, lo_t, n_buckets
    ).numpy()
    diff = got - want
    differ = int((diff != 0).sum())
    if n_buckets < Q_RES:
        assert differ == 0
    elif skewed:
        assert differ <= n // 100, differ
        assert int(np.abs(diff).max()) <= 1
    else:
        assert differ <= n // 1000, differ


@pytest.mark.parametrize("root_slope", [1e30, np.inf])
def test_saturating_root_picks_jax_leaf(root_slope):
    """A root product past 2**31 saturates (JAX: leaf n_leaf - 1), and
    0 * inf = NaN converts to 0 (leaf 0); a naive torch cast would give
    INT_MIN -> leaf 0 for the first."""
    keys = gensort.uniform_keys(2048, seed=9)
    model = jrmi.fit(keys, n_leaf=64)
    model = dataclasses.replace(model, root_slope=np.float32(root_slope))
    (hi_j, lo_j), (hi_t, lo_t) = _words(keys)
    params = trmi.params_from_numpy(model)
    for nb in (256, Q_RES):
        want = np.asarray(jrmi.predict_bucket(model, hi_j, lo_j, nb))
        got = trmi.predict_bucket(params, hi_t, lo_t, nb).numpy()
        np.testing.assert_array_equal(got, want)
    # the hazard is exercised: keys above the minimum route to the last
    # leaf, whose band starts high in the CDF
    cdf = trmi.predict_cdf(params, hi_t, lo_t).numpy()
    assert (cdf >= float(model.leaf_lo[-1])).mean() > 0.9


def test_f32_to_i32_saturates_like_xla():
    v = np.array(
        [0.0, -0.7, 2.9, 3e9, -3e9, np.inf, -np.inf, np.nan, 2147483520.0],
        dtype=np.float32,
    )
    want = np.asarray(jnp.asarray(v).astype(jnp.int32))
    got = trmi.f32_to_i32(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, want)


def _odd_leaves():
    """Five leaves whose u32 words sit at and above 2**31 and whose
    floats are NaN, +-inf and -0.0."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    i64 = lambda v: torch.tensor(v, dtype=torch.int64)
    return dict(
        leaf_slope=f32([0.5, np.nan, np.inf, -np.inf, -0.0]),
        leaf_intercept=f32([0.0, 1e-30, -np.inf, np.nan, 0.25]),
        leaf_lo=f32([0.0, 0.1, np.nan, 0.3, -0.0]),
        leaf_hi=f32([0.1, np.inf, 0.3, np.nan, 1.0]),
        leaf_min_hi=i64([0, 2**31, 2**32 - 1, 2**31 - 1, 2**31 + 5]),
        leaf_min_lo=i64([2**32 - 1, 2**31, 0, 2**31 + 1, 7]),
        leaf_inv_range=f32([1.0, np.nan, np.inf, 3e-38, 1e-10]),
    )


@pytest.mark.parametrize("n_leaf", [1, 5, 1024])
def test_packed_leaf_table_unpacks_bit_for_bit(n_leaf):
    """The kernel's (L, 8) table holds ``ftable()`` and ``utable()`` bit
    for bit: f32 fields as their bit patterns (NaN payloads, infinities
    and -0.0 kept), u32 fields as their low 32 bits (2**31 and up wrap,
    they neither saturate nor raise), and a zero pad word."""
    model = trmi.fit(gensort.uniform_keys(4096, seed=n_leaf), n_leaf=n_leaf)
    if n_leaf == 5:
        model = dataclasses.replace(model, **_odd_leaves())
    table = trmi.pack_leaf_table(model)
    assert table.dtype == torch.int32 and table.shape == (n_leaf, 8)
    assert table.is_contiguous() and table.data_ptr() % 32 == 0
    assert len(trmi.LEAF_ROW) == 8
    f, u = trmi.unpack_leaf_table(table)
    assert torch.equal(f.view(torch.int32), model.ftable().view(torch.int32))
    assert torch.equal(u, model.utable())
    np.testing.assert_array_equal(
        table[:, trmi.LEAF_ROW.index("min_hi")].numpy().view(np.uint32),
        model.leaf_min_hi.numpy().astype(np.uint32),
    )
    assert not table[:, trmi.LEAF_ROW.index("pad")].any()
    # built once per model and device, on the model's device
    assert model.kernel_table is model.kernel_table
    assert torch.equal(model.kernel_table, table)


def _replay(params, hi, lo, n_buckets):
    """``csrc/rmi.cu``'s reading of the packed table in plain torch: each
    record's root leaf, that leaf's one 32-byte row gathered from
    ``kernel_table`` (two halves of four words), and the id computed from
    the row's fields alone."""
    x = tenc.feature_f32(hi, lo, params.min_hi, params.min_lo, params.inv_range)
    root = (x * params.root_slope + params.root_intercept) * params.n_leaf
    leaf = trmi.f32_to_i32(root).clamp(0, params.n_leaf - 1).to(torch.int64)
    row = params.kernel_table[leaf]  # (n, 8): one 32-byte row a record
    first, second = row[:, :4], row[:, 4:]  # the kernel's two 16-byte loads
    half = lambda name: (first, second)[trmi.LEAF_ROW.index(name) // 4]
    word = lambda name: half(name)[:, trmi.LEAF_ROW.index(name) % 4]
    f32 = lambda name: word(name).contiguous().view(torch.float32)
    u32 = lambda name: word(name).to(torch.int64) & 0xFFFFFFFF
    xl = tenc.feature_f32(hi, lo, u32("min_hi"), u32("min_lo"), f32("inv_range"))
    y = torch.clamp(xl * f32("slope") + f32("intercept"), f32("band_lo"), f32("band_hi"))
    return torch.clamp(trmi.f32_to_i32(y * n_buckets), max=n_buckets - 1)


@pytest.mark.parametrize("case", ["n1", "n3", "n4097", "odd_offset"])
@pytest.mark.parametrize("n_buckets", [16, 256, Q_RES])
@pytest.mark.parametrize("skewed", [False, True])
def test_rmi_schedule_replay_equals_eager(case, n_buckets, skewed):
    """The kernel's reading of the packed table, replayed in plain torch,
    gives the JAX eager ``rmi.predict_bucket``'s ids bit for bit, at
    lengths that leave a part-filled last block and warp and on a slice
    at an odd offset (whose words are not 16-byte aligned)."""
    keys = _keys(4098, skewed, 21)
    model = jrmi.fit(keys[::2], n_leaf=256)
    (hi_j, lo_j), (hi_t, lo_t) = _words(keys)
    n = {"n1": 1, "n3": 3, "n4097": 4097, "odd_offset": 4097}[case]
    start = 1 if case == "odd_offset" else 0
    hi_t, lo_t = hi_t[start : start + n], lo_t[start : start + n]
    if case == "odd_offset":
        assert hi_t.data_ptr() % 16 == 8 and lo_t.data_ptr() % 16 == 8
    want = np.asarray(jrmi.predict_bucket(
        model, hi_j[start : start + n], lo_j[start : start + n], n_buckets
    ))
    got = _replay(trmi.params_from_numpy(model), hi_t, lo_t, n_buckets)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
