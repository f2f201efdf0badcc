"""The port's CUDA kernels and device path on a card: each kernel against
its plain PyTorch version, bit for bit, the batched and per-partition
executors and ``sort_file`` on the card against the host executor's
bytes, the per-partition chain and the dual-input RMI call against
their plain versions, a cached model reused on the card, a CUDA
``SortedFileIndex`` against a CPU one, and the mesh-scale sort (router,
``make_sort_fn``, ``sort_file_distributed``) at world size 1 on NCCL
and on gloo; and the LM serving path at smoke size (all ten archs'
forward, prefill and decode on the card against the host,
``bucket_matrix`` on their expert ids, ``ServeEngine``'s default device,
the blockwise attention); and the LM training path at smoke size (all
ten archs' bf16 gradients and one train step on the card against the
host, the microbatched step, a checkpoint from the card to the host and
back, the launcher's resume on the card, serving trained parameters
without a graph, the blockwise attention's backward pass).

Every test needs a CUDA device (a CUDA kernel has no CPU mode) and skips
without one; the check happens when the test runs.  This file imports
neither ``jax`` nor ``repro``, so it runs on a machine with the card
and PyTorch alone; its tests carry the ``cuda`` marker:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import encoding, external, learned_sort  # noqa: E402
from repro_torch.core import operators, partition, rmi as trmi  # noqa: E402
from repro_torch.core.config import SortConfig  # noqa: E402
from repro_torch.core.encoding import SENTINEL  # noqa: E402
from repro_torch.core.executor import (  # noqa: E402
    BatchedDeviceExecutor,
    HostSortExecutor,
    PerPartitionDeviceExecutor,
    make_executor,
)
from repro_torch.core.model_cache import ModelCache  # noqa: E402
from repro_torch.core.format import GENSORT  # noqa: E402
from repro_torch.data import gensort  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    bitonic,
    build,
    encode,
    histogram,
    ops,
    rmi,
)
from repro_torch.serve.index import SortedFileIndex  # noqa: E402
from repro_torch.testing import full_key_ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rows(r, c, dup_range, seed=0):
    rng = np.random.default_rng(seed + r * c)
    hi = rng.integers(0, dup_range, size=(r, c)).astype(np.int64)
    lo = rng.integers(0, 5, size=(r, c)).astype(np.int64)
    val = np.tile(np.arange(c, dtype=np.int32)[::-1], (r, 1))
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in (hi, lo, val)]


@pytest.mark.parametrize("n", [1, 1000, 1 << 17])
def test_encode_kernel_equals_plain(cuda, n):
    keys = torch.from_numpy(gensort.uniform_keys(n, seed=n)[:, :8].copy()).to(cuda)
    hi_k, lo_k = encode.encode_cuda(keys)
    hi_p, lo_p = encode.encode_plain(keys)
    torch.cuda.synchronize()
    assert torch.equal(hi_k, hi_p) and torch.equal(lo_k, lo_p)


def test_encode_kernel_rejects_misaligned(cuda):
    raw = torch.zeros(8 * 64 + 1, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        encode.encode_cuda(raw[1:].view(64, 8))


@pytest.mark.parametrize("k", [1, 8, 10, 12])
@pytest.mark.parametrize("layout", ["contiguous", "odd_offset", "stride16", "stride100"])
@pytest.mark.parametrize("n", [1, 1000, 1 << 17])
def test_encode_full_kernel_equals_plain(cuda, n, layout, k):
    """The full-key kernel reads rows in place at their stride (up to 16
    bytes, from any byte offset); wider strides are copied first by the
    wrapper.  Every word equals the plain version's."""
    rng = np.random.default_rng(n + k)
    raw = torch.from_numpy(rng.integers(0, 256, (n + 1) * 100, dtype=np.uint8)).to(cuda)
    if layout == "contiguous":
        keys = raw[: n * k].view(n, k)
    elif layout == "odd_offset":
        keys = raw[3 : 3 + n * k].view(n, k)
    elif layout == "stride16":
        keys = raw[: n * 16].view(n, 16)[:, :k]
    else:
        keys = raw[: n * 100].view(n, 100)[:, :k]
    assert (encode.row_stride(keys) is None) == (layout == "stride100" and n > 1)
    ops.reset_launches()
    got = ops.encode_full_keys(keys)
    assert ops.encode_full_keys.launches == 1
    for g, w in zip(got, encode.encode_full_plain(keys)):
        assert torch.equal(g, w)


def test_encode_full_kernel_rejects(cuda):
    raw = torch.zeros(64 * 100, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        encode.encode_full_cuda(raw.view(64, 100)[:, :10])  # stride 100
    with pytest.raises(ValueError):
        ops.encode_full_keys(raw[: 64 * 13].view(64, 13))  # 13 bytes


@pytest.mark.parametrize("n_leaf", [64, 25_000])
@pytest.mark.parametrize("n_buckets", [256, 1 << 20])
@pytest.mark.parametrize("skewed", [False, True])
def test_rmi_kernel_equals_plain(cuda, n_leaf, n_buckets, skewed):
    n = 1 << 18
    keys = (
        gensort.skewed_keys(n, seed=3) if skewed
        else gensort.uniform_keys(n, seed=3)
    )
    model = trmi.fit(keys[::2], n_leaf=n_leaf).to(cuda)
    hi, lo = encode.encode_cuda(torch.from_numpy(keys[:, :8].copy()).to(cuda))
    got = rmi.rmi_bucket_cuda(model, hi, lo, n_buckets)
    want = rmi.rmi_bucket_plain(model, hi, lo, n_buckets)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_rmi_kernel_saturating_root(cuda):
    """Root products past 2**31 saturate and NaN routes to leaf 0, in the
    kernel as in the plain version."""
    keys = gensort.uniform_keys(4096, seed=4)
    model = trmi.fit(keys, n_leaf=64)
    hi, lo = encode.encode_cuda(torch.from_numpy(keys[:, :8].copy()).to(cuda))
    for slope in (1e30, float("inf")):
        m = trmi.RMIParams(**{
            **{f: getattr(model, f) for f in model.__dataclass_fields__},
            "root_slope": torch.tensor(slope, dtype=torch.float32),
        }).to(cuda)
        got = rmi.rmi_bucket_cuda(m, hi, lo, 1 << 20)
        want = rmi.rmi_bucket_plain(m, hi, lo, 1 << 20)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["n1", "n3", "n4097", "odd_offset"])
@pytest.mark.parametrize("n_buckets", [16, 256, 1 << 20])
@pytest.mark.parametrize("skewed", [False, True])
def test_rmi_kernel_tails_and_offsets(cuda, case, n_buckets, skewed):
    """Lengths that leave a part-filled last warp and block, and a slice
    at an odd offset (its words not 16-byte aligned)."""
    keys = (
        gensort.skewed_keys(4098, seed=21) if skewed
        else gensort.uniform_keys(4098, seed=21)
    )
    model = trmi.fit(keys[::2], n_leaf=256).to(cuda)
    hi, lo = encode.encode_cuda(torch.from_numpy(keys[:, :8].copy()).to(cuda))
    n = {"n1": 1, "n3": 3, "n4097": 4097, "odd_offset": 4097}[case]
    start = 1 if case == "odd_offset" else 0
    hi, lo = hi[start : start + n], lo[start : start + n]
    got = rmi.rmi_bucket_cuda(model, hi, lo, n_buckets)
    want = rmi.rmi_bucket_plain(model, hi, lo, n_buckets)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_rmi_kernel_packed_row_edge_values(cuda):
    """Leaves whose u32 words are 2**31 and above and whose floats are
    NaN or infinite: the kernel reads them from the packed row as the
    plain version reads the separate fields."""
    keys = gensort.uniform_keys(4096, seed=8)
    model = trmi.fit(keys, n_leaf=5)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    i64 = lambda v: torch.tensor(v, dtype=torch.int64)
    model = trmi.RMIParams(**{
        **{f: getattr(model, f) for f in model.__dataclass_fields__},
        "leaf_slope": f32([0.5, float("nan"), float("inf"), 0.0, 2.0]),
        "leaf_intercept": f32([0.0, 0.1, float("-inf"), float("nan"), 0.25]),
        "leaf_min_hi": i64([0, 2**31, 2**32 - 1, 2**31 - 1, 2**31 + 5]),
        "leaf_min_lo": i64([2**32 - 1, 2**31, 0, 2**31 + 1, 7]),
        "leaf_inv_range": f32([1.0, float("nan"), float("inf"), 3e-38, 1e-10]),
    }).to(cuda)
    table = model.kernel_table
    assert table.is_cuda and table.data_ptr() % 32 == 0
    hi, lo = encode.encode_cuda(torch.from_numpy(keys[:, :8].copy()).to(cuda))
    for n_buckets in (256, 1 << 20):
        got = rmi.rmi_bucket_cuda(model, hi, lo, n_buckets)
        want = rmi.rmi_bucket_plain(model, hi, lo, n_buckets)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


ROW_KINDS = ["random", "dups", "val_ties", "equal", "sentinel_rows",
             "presorted", "reversed"]


def _kind_rows(r, c, kind, seed=0):
    """(r, c) rows of one kind: random words, few distinct keys, equal
    keys with tied vals, all-equal keys, SENTINEL-only rows between
    random ones, rows already sorted, rows sorted in reverse."""
    rng = np.random.default_rng(seed + r * c)
    hi = rng.integers(0, 2**32, size=(r, c))
    lo = rng.integers(0, 2**32, size=(r, c))
    val = rng.integers(-(2**31), 2**31 - 1, size=(r, c))
    if kind == "dups":
        hi, lo = hi % 3, lo % 5
        val = np.tile(np.arange(c)[::-1], (r, 1))
    elif kind == "val_ties":
        hi, lo, val = hi % 2, lo % 2, val % 3
    elif kind == "equal":
        hi[:], lo[:] = 7, 11
    elif kind == "sentinel_rows":
        hi[::2], lo[::2], val[::2] = SENTINEL, SENTINEL, 2**31 - 1
    rows = [
        torch.from_numpy(np.ascontiguousarray(a).astype(d))
        for a, d in ((hi, np.int64), (lo, np.int64), (val, np.int32))
    ]
    if kind in ("presorted", "reversed"):
        rows = list(bitonic.sort_rows_plain(*rows))
        if kind == "reversed":
            rows = [t.flip(1).contiguous() for t in rows]
    return rows


@pytest.mark.parametrize("kind", ROW_KINDS)
@pytest.mark.parametrize("c", [1 << i for i in range(15)])
def test_bitonic_kernel_equals_plain(cuda, c, kind):
    """Every width from 1 to 16,384, so every layout of the kernel runs
    (a thread a row, part of a warp, a warp, a block a row), on a row
    count that leaves the last block and its last warp part-filled."""
    geo = bitonic.launch_geometry(c)
    r = 3
    if geo.rows_per_block > 1:
        r = geo.rows_per_block + 32 // geo.threads_per_row + 1
    args = [t.to(cuda) for t in _kind_rows(r, c, kind)]
    got = bitonic.sort_rows_cuda(*args)
    want = bitonic.sort_rows_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_bitonic_kernel_rejects_widths(cuda):
    for c in (100, 2 * bitonic.MAX_WIDTH):
        args = [t.to(cuda) for t in _rows(1, c, 3)]
        with pytest.raises(ValueError):
            bitonic.sort_rows_cuda(*args)


def _ids(n, n_buckets, kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "equal":
        ids = np.full(n, n_buckets // 3, dtype=np.int32)
    else:
        ids = rng.integers(0, n_buckets, size=n, dtype=np.int32)
    if kind == "out_of_range":
        bad = rng.choice(n, size=n // 5, replace=False)
        ids[bad] = rng.choice(
            np.array([-1, -9, n_buckets, 2**31 - 1], np.int32), size=bad.size
        )
    return torch.from_numpy(ids)


@pytest.mark.parametrize("kind", ["uniform", "out_of_range", "equal"])
@pytest.mark.parametrize(
    "n,n_buckets",
    [(1, 1), (1000, 8), (1_441_792, 8192), (100_000, 58_000),
     (100_000, 58_113), (1_441_792, 116_224), (1_441_792, 464_896),
     (1_441_792, 1 << 20), (5000, 100_000)],
)
def test_histogram_kernel_equals_plain(cuda, n, n_buckets, kind):
    """Every strategy (a private histogram a block, reduced over a
    cluster, up to 58,112 bins; the bins split over a cluster of 2 up to
    2 x 58,112; global atomics beyond), -1 and other out-of-range ids,
    all-equal ids."""
    ids = _ids(n, n_buckets, kind, seed=n).to(cuda)
    got = histogram.histogram_cuda(ids, n_buckets)
    want = histogram.histogram_plain(ids, n_buckets)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    in_range = int(((ids >= 0) & (ids < n_buckets)).sum())
    assert int(got.sum()) == in_range


def test_histogram_strategy_threshold(cuda):
    """The H100 opts a block into 227 KB of shared memory: a private
    histogram a block up to 58,112 bins, the bins split over a cluster of
    2 up to 116,224, global atomics beyond -- read from the device's own
    attribute."""
    max_bins = histogram.max_block_bins()
    if "H100" in torch.cuda.get_device_properties(cuda).name:
        assert max_bins == 232_448 // 4
    geo = lambda b: histogram.launch_geometry(b, max_bins)
    assert geo(max_bins).strategy == "shared"
    assert geo(max_bins + 1)[:2] == ("split", 2)
    assert geo(2 * max_bins)[:2] == ("split", 2)
    assert geo(2 * max_bins + 1).strategy == "global"
    for n_buckets in (max_bins, max_bins + 1, 2 * max_bins, 2 * max_bins + 1):
        ids = _ids(100_000, n_buckets, "uniform").to(cuda)
        assert torch.equal(
            histogram.histogram_cuda(ids, n_buckets),
            histogram.histogram_plain(ids, n_buckets),
        )
    with pytest.raises(ValueError):
        histogram.histogram_cuda(torch.zeros(4, dtype=torch.int64, device=cuda), 4)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_histogram_every_cluster_size(cuda, cluster):
    """The launch takes clusters of 1 to 16 blocks in both cluster
    strategies (the geometry picks 8 and 2; the others are measured by
    experiments/rmi_histogram_variants.py)."""
    lib = build.library()
    stream = torch.cuda.current_stream().cuda_stream
    for n_buckets, strategy in ((8192, "shared"), (100_000, "split")):
        part = -(-n_buckets // cluster)
        if strategy == "split" and part > histogram.max_block_bins():
            continue
        block = n_buckets if strategy == "shared" else part
        ids = _ids(300_000, n_buckets, "uniform", seed=cluster).to(cuda)
        out = torch.empty(n_buckets, dtype=torch.int32, device=cuda)
        build.check(lib.repro_histogram(
            ids.data_ptr(), ids.shape[0], n_buckets,
            histogram.STRATEGIES.index(strategy), cluster, block, part,
            out.data_ptr(), stream,
        ), "histogram kernel")
        assert torch.equal(out, histogram.histogram_plain(ids, n_buckets))


@pytest.mark.parametrize("n_buckets", [1, 8, 1000, 8192, 58_113])
@pytest.mark.parametrize("kind", ["equal", "skewed", "tail"])
def test_histogram_kernel_aggregates_equal_ids(cuda, n_buckets, kind):
    """Equal ids: all-equal ids (one add a warp step), Zipf-skewed ids
    (many equal ids in a step), and a length that ends inside a step."""
    rng = np.random.default_rng(n_buckets)
    n = 300_001 if kind == "tail" else 1 << 20
    if kind == "equal":
        ids = np.full(n, n_buckets - 1, np.int32)
    elif kind == "skewed":
        ids = np.minimum(rng.zipf(1.3, size=n) - 1, n_buckets - 1).astype(np.int32)
    else:
        ids = rng.integers(-2, n_buckets + 2, size=n, dtype=np.int32)
    ids = torch.from_numpy(ids).to(cuda)
    got = histogram.histogram_cuda(ids, n_buckets)
    want = histogram.histogram_plain(ids, n_buckets)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    keep = (ids >= 0) & (ids < n_buckets)
    assert torch.equal(
        got, torch.bincount(ids[keep], minlength=n_buckets).to(torch.int32)
    )


def test_cuda_index_lookups_equal_cpu(cuda, tmp_path):
    """A CUDA index predicts through the RMI kernel and answers as a CPU
    index does, for hits, misses and ranges."""
    inp, out = str(tmp_path / "in.bin"), str(tmp_path / "out.bin")
    gensort.write_file(inp, 50_000, skewed=True, seed=2)
    external.sort_file(inp, out, config=SortConfig(manifest=True))
    gpu = SortedFileIndex.open(out)
    cpu = SortedFileIndex.open(out, device="cpu")
    rng = np.random.default_rng(0)
    keys = np.concatenate([
        gpu.keys_at(rng.choice(gpu.n, 500)),
        gensort.uniform_keys(100, seed=9),
    ])
    ops.reset_launches()
    for batch in (1, 64):
        for i in range(0, keys.shape[0], batch):
            k = keys[i : i + batch]
            for a, b in zip(gpu.lookup(k), cpu.lookup(k, use_kernels=True)):
                np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        gpu.predict_positions(keys), cpu.predict_positions(keys, use_kernels=True)
    )
    assert ops.rmi_bucket.launches > 0
    lo, hi = sorted(keys[:2].tolist())
    assert np.array_equal(
        gpu.range_scan(bytes(lo), bytes(hi)), cpu.range_scan(bytes(lo), bytes(hi))
    )
    assert gpu.observed_err_lo <= gpu.manifest.err_lo
    assert gpu.observed_err_hi <= gpu.manifest.err_hi
    gpu.close()
    cpu.close()


def _glue_ids(kind, rng):
    """(ids, n_buckets, strategy): the patterns the glue counts in the
    benchmark's cells -- the router's 4 destinations (5 with its discard
    bucket), a rank's received slots at 2^20 bins whose senders' rows end
    in runs of the last bin (longer than a grid's stride, so a warp meets
    a run in many steps), ``sort_device``'s 2^16 bins, and a spike of a
    few hot bins in random order at 2^17."""
    if kind in ("route", "route_discard"):
        nb = 4 if kind == "route" else 5
        return rng.integers(0, nb, 1 << 22, dtype=np.int32), nb, "shared"
    if kind == "padding":
        nb = 1 << 20
        ids = rng.integers(0, nb, 1 << 25, dtype=np.int32)
        ids.reshape(4, -1)[:, 1 << 22 :] = nb - 1
        return ids, nb, "global"
    if kind == "split":
        nb = 1 << 16
        return rng.integers(0, nb, 1 << 22, dtype=np.int32), nb, "split"
    nb = 1 << 17
    ids = rng.integers(0, nb, 1 << 22, dtype=np.int32)
    spike = rng.random(ids.size) < 0.5
    ids[spike] = rng.choice(rng.integers(0, nb, 9), size=int(spike.sum()))
    return ids, nb, "global"


@pytest.mark.parametrize(
    "kind", ["route", "route_discard", "padding", "split", "spike"])
def test_glue_counts_by_the_kernel(cuda, kind):
    """``partition.bucket_histogram`` on a CUDA tensor launches the
    histogram kernel once, in the strategy its bin count picks, and its
    counts equal ``np.bincount``'s."""
    ids, nb, strategy = _glue_ids(kind, np.random.default_rng(len(kind)))
    ops.reset_launches()
    got = partition.bucket_histogram(torch.from_numpy(ids).to(cuda), nb)
    assert ops.bucket_histogram.launches == 1
    assert ops.bucket_histogram.strategy_launches[strategy] == 1
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.cpu().numpy(), np.bincount(ids, minlength=nb))


def test_wrappers_count_launches(cuda):
    ops.reset_launches()
    keys = torch.from_numpy(gensort.uniform_keys(4096, seed=5)).to(cuda)
    hi, lo = ops.encode_keys(keys)
    model = trmi.fit(gensort.uniform_keys(4096, seed=5), n_leaf=64).to(cuda)
    ops.rmi_bucket(model, hi, lo, 16)
    # a non-power-of-two width is padded, sorted by the kernel, sliced back
    h, l, v = ops.sort_rows(
        hi[:4000].reshape(40, 100), lo[:4000].reshape(40, 100),
        torch.arange(4000, dtype=torch.int32, device=cuda).reshape(40, 100),
    )
    assert h.shape == (40, 100)
    ops.bucket_histogram(ops.rmi_bucket(model, hi, lo, 16), 16)
    ops.encode_full_keys(keys)
    assert [f.launches for f in ops.KERNEL_WRAPPERS] == [1, 2, 1, 1, 1]
    assert ops.bucket_histogram.strategy_launches == {
        "global": 0, "shared": 1, "split": 0}
    # a launch the kernel refuses (int64 ids) is not counted
    with pytest.raises(ValueError):
        ops.bucket_histogram(torch.zeros(4, dtype=torch.int64, device=cuda), 4)
    assert ops.bucket_histogram.launches == 1
    with pytest.raises(ValueError):
        rmi.rmi_bucket_cuda(trmi.fit(gensort.uniform_keys(64), n_leaf=4), hi, lo, 16)


def _blocks(sizes, seed=0, dup=False):
    rng = np.random.default_rng(seed)
    recs = gensort.make_records(sum(sizes), seed=seed)
    if dup:
        recs[:, : gensort.KEY_BYTES] = recs[0, : gensort.KEY_BYTES]
    else:
        kv = recs[:, : gensort.KEY_BYTES].copy().view("S10").reshape(-1)
        recs = recs[np.argsort(kv, kind="stable")]
    out, off = [], 0
    for m in sizes:
        part = recs[off : off + m][rng.permutation(m)]
        off += m
        out.append(GENSORT.parse_blob(part.tobytes()))
    return out


@pytest.mark.parametrize(
    "sizes,dup,kw",
    [
        ([100, 1023, 1024, 1025, 7], False, {}),
        ([400] * 24, False, {"batch_slots": 2048}),  # many batches in flight
        ([2000, 500], True, {}),  # overflow -> stable fallback
    ],
)
def test_executor_on_card_matches_host(cuda, sizes, dup, kw):
    model = trmi.fit(gensort.uniform_keys(4096, seed=0), n_leaf=256)
    blocks = _blocks(sizes, seed=len(sizes), dup=dup)
    ops.reset_launches()
    ex = BatchedDeviceExecutor(model, device=cuda, **kw)
    assert not ex.flat
    got = dict(ex.sort_iter(enumerate(blocks)))
    host = dict(HostSortExecutor(model).sort_iter(enumerate(blocks)))
    for i in range(len(blocks)):
        assert got[i].tobytes() == host[i].tobytes(), i
    # every kernel once a dispatch: the histogram counts the grid's rows
    assert [f.launches for f in ops.KERNEL_WRAPPERS] == [ex.dispatches] * 4 + [0]
    assert (ex.fallbacks >= 1) == dup


def test_executor_defaults_to_the_card(cuda):
    """Without ``device=`` both entry points build a CUDA executor."""
    model = trmi.fit(gensort.uniform_keys(4096, seed=0), n_leaf=64)
    for ex in (make_executor(model), BatchedDeviceExecutor(model)):
        assert isinstance(ex, BatchedDeviceExecutor)
        assert ex.device.type == "cuda" and not ex.flat
        assert ex.model.device.type == "cuda"


@pytest.mark.parametrize("n_readers", [1, 3])
def test_sort_file_on_card_matches_host(cuda, tmp_path, n_readers):
    n = 50_000
    inp = str(tmp_path / "in.bin")
    gensort.write_file(inp, n, skewed=True, seed=11)
    shas = {}
    for name, cfg in (
        ("card", SortConfig(n_readers=n_readers, memory_budget_bytes=2 << 20)),
        ("host", SortConfig(device="cpu", executor="host")),
    ):
        out = str(tmp_path / f"{name}.bin")
        stats = external.sort_file(inp, out, config=cfg)
        with open(out, "rb") as f:
            shas[name] = hashlib.sha256(f.read()).hexdigest()
        if name == "card":
            assert stats.executor == "batched" and stats.device_dispatches > 0
    assert shas["card"] == shas["host"]


def test_rmi_bucket_pair_one_launch(cuda):
    keys = gensort.skewed_keys(5000, seed=3)
    model = trmi.fit(keys, n_leaf=256)
    words = [t.to(cuda) for t in encoding.encode(torch.from_numpy(keys))]
    hi, lo = (w.contiguous() for w in words)
    ops.reset_launches()
    a, b = ops.rmi_bucket_pair(model.to(cuda), hi[:1234], lo[:1234],
                               hi[1234:], lo[1234:], 64)
    assert ops.rmi_bucket.launches == 1
    want = rmi.rmi_bucket_plain(model, hi.cpu(), lo.cpu(), 64)
    assert torch.equal(torch.cat([a, b]).cpu(), want)


@pytest.mark.parametrize("n", [3, 4097, 1 << 20])
@pytest.mark.parametrize("kind", ["uniform", "skewed"])
def test_sort_device_kernels_equal_plain(cuda, n, kind):
    """The chain on the card (RMI and row-sort kernels; 2,048-wide rows
    at 2**20) equals the same chain on the CPU (their plain versions),
    overflow fallback included (2**20 skewed keys flood a bucket)."""
    gen = gensort.skewed_keys if kind == "skewed" else gensort.uniform_keys
    keys = gen(n, seed=n)
    model = trmi.fit(keys[:: max(1, n // 65536)], n_leaf=max(1024, n // 256))
    hi, lo = encoding.encode(torch.from_numpy(keys))
    *want, want_overflow = learned_sort.sort_device(
        model, hi, lo, return_overflow=True
    )
    ops.reset_launches()
    *got, overflow = learned_sort.sort_device(
        model.to(cuda), hi.to(cuda), lo.to(cuda), return_overflow=True
    )
    assert overflow == want_overflow
    if kind == "uniform":  # the compacted rows are the answer
        assert not overflow
    # the rows are sorted only when no bucket overflowed
    assert (ops.rmi_bucket.launches, ops.sort_rows.launches) == (
        1, int(not overflow)
    )
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("n", [3, 4097, 1 << 20])
@pytest.mark.parametrize("kind", ["uniform", "skewed", "ties"])
def test_sort_device_full_key_kernels_equal_plain(cuda, n, kind):
    """The full-key chain on the card (the encode kernel, the RMI and
    row-sort kernels, the tie pass) equals it on the CPU and the plain
    reference; ``ties`` plants a run of 8-byte ties with other tails in
    uniform keys, which stay on the row path."""
    gen = gensort.skewed_keys if kind == "skewed" else gensort.uniform_keys
    keys = gen(n, seed=n)
    if kind == "ties":
        keys[1 : min(n, 600) : 3, :8] = keys[0, :8]
    model = trmi.fit(keys[:: max(1, n // 65536)], n_leaf=max(1024, n // 256))
    t = torch.from_numpy(keys)
    want = learned_sort.sort_device(model, *ops.encode_full_keys(t), return_overflow=True)
    ops.reset_launches()
    got = learned_sort.sort_device(model.to(cuda), *ops.encode_full_keys(t.to(cuda)),
                                   return_overflow=True)
    assert ops.encode_full_keys.launches == 1
    assert got[4] == want[4]
    if kind != "skewed":
        assert not got[4]
    for g, w in zip(got[:4], want[:4]):
        assert torch.equal(g.cpu(), w)
    for g, w in zip(got[:4], full_key_ref.full_key_sort(t)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize(
    "n,skewed,budget,parts",
    [
        (50_000, True, 2 << 20, 0),  # padded partitions: stable fallback
        (1 << 16, False, 256 << 20, 1),  # one 2**16 partition: the rows
    ],
)
def test_per_partition_executor_on_card(cuda, tmp_path, n, skewed, budget,
                                        parts):
    """The "cuda" default, and sort_file through one chain a partition
    writes the host executor's bytes, whether the partition's padding
    overflows its last bucket or the compacted rows are the answer."""
    model = trmi.fit(gensort.uniform_keys(4096, seed=0), n_leaf=64)
    for ex in (make_executor(model, executor="per_partition"),
               PerPartitionDeviceExecutor(model)):
        assert ex.device.type == "cuda" and ex.model.device.type == "cuda"
    inp = str(tmp_path / "in.bin")
    gensort.write_file(inp, n, skewed=skewed, seed=12)
    shas = {}
    ops.reset_launches()
    for name, cfg in (
        ("card", SortConfig(executor="per_partition", n_partitions=parts,
                            memory_budget_bytes=budget)),
        ("host", SortConfig(device="cpu", executor="host")),
    ):
        out = str(tmp_path / f"{name}.bin")
        stats = external.sort_file(inp, out, config=cfg)
        with open(out, "rb") as f:
            shas[name] = hashlib.sha256(f.read()).hexdigest()
        if name == "card":
            assert stats.executor == "per_partition"
            assert ops.rmi_bucket.launches == stats.device_dispatches > 0
            assert ops.sort_rows.launches == (
                stats.device_dispatches - stats.fallbacks
            )
            if parts == 1:
                assert (stats.device_dispatches, stats.fallbacks) == (1, 0)
    assert shas["card"] == shas["host"]


def test_cached_model_stays_on_card(cuda, tmp_path):
    """A cache hit sorts with the device copy (and packed kernel table)
    the first sort uploaded."""
    inp = str(tmp_path / "in.bin")
    gensort.write_file(inp, 30_000, seed=4)
    cache = ModelCache()
    shas = []
    for k in range(2):
        out = str(tmp_path / f"{k}.bin")
        st = external.sort_file(inp, out, config=SortConfig(
            model_cache=cache, memory_budget_bytes=2 << 20))
        assert st.model_cache == ("miss", "hit")[k]
        with open(out, "rb") as f:
            shas.append(hashlib.sha256(f.read()).hexdigest())
        if k == 0:
            copy = next(iter(cache._entries.values())).to(cuda)
            table = copy.kernel_table
    entry = next(iter(cache._entries.values()))
    assert entry.to(cuda) is copy and copy.kernel_table is table
    assert shas[0] == shas[1]


def test_verify_co_partitioning_on_card(cuda, tmp_path):
    from repro_torch.core.format import LineFormat
    from repro_torch.data import lines

    a, b = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    lines.write_keyed_lines(a, 20_000, key_space=5_000, seed=11)
    lines.write_keyed_lines(b, 20_000, key_space=5_000, key_offset=4_500,
                            seed=23)
    operators.sort_co_partitioned(
        [a, b], [a + ".s", b + ".s"], fmt=LineFormat(max_key_bytes=12),
        memory_budget_bytes=1 << 20, n_partitions=7,
    )
    left, right = operators._Run.open(a + ".s"), operators._Run.open(b + ".s")
    ops.reset_launches()
    n = operators.verify_co_partitioning(left, right, use_kernels=True)
    assert ops.rmi_bucket.launches == 1
    assert n == operators.verify_co_partitioning(left, right) > 0


# ---------------------------------------------------------------------------
# The mesh-scale sort on the card, in this process at world size 1
# ---------------------------------------------------------------------------


@pytest.fixture(params=["nccl", "gloo"])
def card_mesh(cuda, tmp_path, request):
    """A 1-rank process group on the card, NCCL or gloo, torn down
    after the test."""
    from repro_torch.launch import mesh as tmesh

    tmesh.initialize_multiprocess(
        f"file://{tmp_path / 'store'}", 1, 0, backend=request.param,
        device="cuda", timeout_s=60,
    )
    try:
        mesh = tmesh.make_data_mesh()
        assert mesh.backend == request.param and mesh.device.type == "cuda"
        yield mesh
    finally:
        torch.distributed.destroy_process_group()


def test_router_on_card(card_mesh):
    """The route function buckets with the RMI kernel, keeps the words
    on the card, and delivers every real row of a padded chunk."""
    from repro_torch.core import terasort

    n = 5000
    keys = gensort.uniform_keys(n, seed=2)
    model = trmi.fit(keys, n_leaf=256)
    words = np.full((2, 5120), SENTINEL, dtype=np.int64)
    words[0, :n], words[1, :n] = encoding.encode_np(keys)
    hi, lo = torch.from_numpy(words).to(card_mesh.device)
    val = torch.arange(5120, dtype=torch.int32, device=card_mesh.device)
    val[n:] = -1  # padding rows, as _stripe marks them
    ops.reset_launches()
    route = terasort._make_route_fn(card_mesh, model, 5120, 1.6)
    out, n_valid, lost = route(hi, lo, val)
    assert ops.rmi_bucket.launches == 1
    assert out.is_cuda and n_valid.is_cuda and lost.is_cuda
    assert int(lost[0]) == 0 and int(n_valid[0]) == n
    assert sorted(out[:n].tolist()) == list(range(n))


def test_make_sort_fn_on_card(card_mesh):
    """``make_sort_fn`` at world size 1 on the card equals the CPU run
    (no process group) word for word, and sorts every key."""
    from repro_torch.core import distributed
    from repro_torch.launch import mesh as tmesh

    n = 1 << 16
    keys = gensort.skewed_keys(n, seed=4)
    model = trmi.fit(keys[::16], n_leaf=512)
    hi, lo = (torch.from_numpy(w.astype(np.int64)) for w in encoding.encode_np(keys))
    val = torch.arange(n, dtype=torch.int32)
    ops.reset_launches()
    fn = distributed.make_sort_fn(card_mesh, ("data",), model, n)
    got = fn(hi.to(card_mesh.device), lo.to(card_mesh.device),
             val.to(card_mesh.device))
    assert ops.rmi_bucket.launches >= 2  # the router and sort_device
    assert all(t.is_cuda for t in got)
    cpu = tmesh.DataMesh(None, 0, 1, torch.device("cpu"))  # no group
    want = distributed.make_sort_fn(cpu, ("data",), model, n)(hi, lo, val)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    gh, gl, gv = distributed.global_sorted_from_shards(*got[:4], 1)
    o = np.lexsort((lo.numpy(), hi.numpy()))
    assert (gh == hi.numpy()[o]).all() and (gl == lo.numpy()[o]).all()
    assert int(got[4][0]) == 0 and len(np.unique(gv)) == n


@pytest.mark.parametrize("executor", ["batched", "mesh"])
def test_sort_file_distributed_on_card(card_mesh, tmp_path, executor):
    """``sort_file_distributed`` on the card writes the host executor's
    bytes, through the RMI kernel (the router) and the encode kernel
    (the final pass)."""
    from repro_torch.core import terasort

    n = 40_000
    inp = str(tmp_path / "in.bin")
    gensort.write_file(inp, n, skewed=True, seed=13)
    host = str(tmp_path / "host.bin")
    external.sort_file(inp, host, config=SortConfig(device="cpu", executor="host"))
    out = str(tmp_path / "out.bin")
    ops.reset_launches()
    stats = terasort.sort_file_distributed(
        inp, out, card_mesh, chunk_records=8192, executor=executor,
        workdir=str(tmp_path),
    )
    with open(out, "rb") as a, open(host, "rb") as b:
        assert a.read() == b.read()
    assert stats.executor == executor and stats.device_dispatches >= 1
    assert ops.rmi_bucket.launches >= 5 and ops.encode_keys.launches >= 1


# ---------------------------------------------------------------------------
# The LM serving path on the card (chip_smoke.py phase 11 (c), smoke size)
# ---------------------------------------------------------------------------

LM_ARCHS = ("qwen3-4b", "qwen3-8b", "yi-9b", "qwen2-72b", "mixtral-8x7b",
            "moonshot-v1-16b-a3b", "internvl2-26b", "jamba-v0.1-52b", "xlstm-350m",
            "whisper-medium")
LM_TOL = 5e-2  # tests/test_torch_lm_serve.py's float tolerance


@pytest.fixture
def lm_card(cuda):
    """The card with f32 accumulation in bf16 products, as the reference
    accumulates; restored after the test."""
    old = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield cuda
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = old


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_on_card_matches_host(lm_card, arch):
    """Forward and prefill logits on the card within ``LM_TOL`` of the
    host's with the same parameters; the MoE metrics equal; decode steps
    advance the card's cache (attention K/V and recurrent states, all on
    the card); ``bucket_matrix`` on the expert ids bit-equal."""
    import copy

    from repro_torch.configs import registry
    from repro_torch.core import partition
    from repro_torch.models import layers, moe, transformer
    from repro_torch.models.api import build_model

    cfg = registry.get_config(arch, smoke=True)
    model = build_model(cfg)
    cpu = model.init_params(seed=0, device="cpu")
    gpu = copy.deepcopy(cpu).to(lm_card)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_raw, (2, 16)).astype(np.int32))
    fe = None
    if cfg.frontend != "none":
        fe = torch.from_numpy(rng.standard_normal(
            (2, cfg.n_frontend_tokens, cfg.d_frontend)).astype(np.float32))
    host = {"tokens": toks, "frontend_embeds": fe}
    card = {k: None if v is None else v.to(lm_card) for k, v in host.items()}
    (lc, ac), (lg, ag) = model.forward(cpu, host), model.forward(gpu, card)
    assert lg.is_cuda and lg.dtype == torch.float32
    torch.testing.assert_close(lg.cpu(), lc, atol=LM_TOL, rtol=LM_TOL)
    if cfg.moe:
        assert float(ag["moe_dropped_frac"]) == float(ac["moe_dropped_frac"])
    max_seq = 24 + (cfg.n_frontend_tokens if cfg.frontend == "vit" else 0)
    (pc, cc), (pg, cg) = (model.prefill(cpu, host, max_seq=max_seq),
                          model.prefill(gpu, card, max_seq=max_seq))
    torch.testing.assert_close(pg.cpu(), pc, atol=LM_TOL, rtol=LM_TOL)
    nxt = pc.argmax(-1).to(torch.int32)[:, None]
    for _ in range(3):
        lc1 = model.decode_logits(cpu, cc, nxt)
        lg1 = model.decode_logits(gpu, cg, nxt.to(lm_card))
        torch.testing.assert_close(lg1.cpu(), lc1, atol=LM_TOL, rtol=LM_TOL)
        nxt = lc1.argmax(-1).to(torch.int32)
    assert cg.pos == cc.pos and all(
        t.is_cuda for layer in cg.layers for c in layer.values() for t in c.values())
    if cfg.moe:
        p = next(layer[s] for layer in cpu.layers for s in layer if s.endswith("moe"))
        x = transformer.embed_inputs(cfg, cpu, toks)
        xn = layers.rms_norm(x, p.norm, cfg.norm_eps).reshape(-1, cfg.d_model)
        ids = moe.route(p, cfg, xn)[3].reshape(-1).to(torch.int32)
        for capacity in (8, 24, 64):
            host = partition.bucket_matrix(ids, cfg.moe.n_experts, capacity)
            card = partition.bucket_matrix(ids.to(lm_card), cfg.moe.n_experts, capacity)
            for h, c in zip(host, card):
                assert torch.equal(c.cpu(), h)


def test_serve_engine_defaults_to_card(lm_card):
    from repro_torch.configs import registry
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import ServeEngine

    cfg = registry.get_config("mixtral-8x7b", smoke=True)
    engine = ServeEngine(build_model(cfg), seed=0)
    assert engine.params.embed.is_cuda
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_raw, (3, 20)).astype(np.int32)
    out = engine.generate(prompts, 24)  # past the window of 16
    assert out.shape == (3, 24) and out.dtype == np.int32
    assert engine.stats.logits_finite and engine.stats.decode_steps == 23


@pytest.mark.parametrize("window", [0, 100, 4096])
def test_sdpa_chunked_on_card(lm_card, window):
    """The blockwise attention on the card against the dense one at the
    shapes of ``tests/test_attention.py`` (f32)."""
    from repro_torch.models import attention

    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32) * sc).to(lm_card)
               for s, sc in (((2, 4096, 4, 16), 0.3), ((2, 4096, 2, 16), 0.3),
                             ((2, 4096, 2, 16), 1.0)))
    i = torch.arange(4096, device=lm_card)[:, None]
    j = torch.arange(4096, device=lm_card)[None, :]
    mask = (j <= i) & ((j > i - window) if window else True)
    dense = attention._sdpa(q, k, v, mask[None], 2)
    out = attention._sdpa_chunked(q, k, v, 2, window=window)
    torch.testing.assert_close(out, dense, atol=3e-5, rtol=0)


# ---------------------------------------------------------------------------
# The LM training path on the card (chip_smoke.py phase 12 (c), smoke size)
# ---------------------------------------------------------------------------

# tests/test_torch_train_grads.py's per-leaf gradient tolerance
GRAD_TOL, GRAD_FLOOR = 0.05, 1e-3


def _train_batch(cfg, dev, b=4, s=16):
    from repro_torch.data.pipeline import PipelineConfig, SyntheticLM

    batch = SyntheticLM(PipelineConfig(cfg.vocab_raw, s, b)).batch_at(0)
    if cfg.frontend != "none":
        batch["frontend_embeds"] = np.random.default_rng(0).standard_normal(
            (b, cfg.n_frontend_tokens, cfg.d_frontend)).astype(np.float32)
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def _grad_errors(got: dict, want: dict) -> dict:
    """Each leaf's relative L2 error, with tests/test_torch_train_grads.py's
    floor."""
    total = sum(float(w.float().square().sum()) for w in want.values()) ** 0.5
    return {n: float((got[n].float().cpu() - w.float()).norm())
            / max(float(w.float().norm()), GRAD_FLOOR * total) for n, w in want.items()}


@pytest.mark.parametrize("arch, microbatches", [(a, 1) for a in LM_ARCHS]
                         + [("yi-9b", 2)])
def test_train_step_on_card_matches_host(lm_card, arch, microbatches):
    """The same parameters on the card and the host: ``grads_of``'s bf16
    gradients within ``GRAD_TOL`` leaf by leaf, and one
    ``build_train_step`` step's loss within ``LM_TOL`` and update within
    the reference's ``dd < 0.35 * d1``."""
    import copy

    from repro_torch.configs import registry
    from repro_torch.models.api import build_model
    from repro_torch.train import optimizer as opt_lib, train_loop

    cfg = registry.get_config(arch, smoke=True)
    model = build_model(cfg)
    cpu = model.trainable(model.init_params(seed=0, device="cpu"))
    gpu = copy.deepcopy(cpu).to(lm_card)
    host, card = _train_batch(cfg, "cpu"), _train_batch(cfg, lm_card)
    lc, _, gc = train_loop.grads_of(model, cpu, host, microbatches=microbatches)
    lg, _, gg = train_loop.grads_of(model, gpu, card, microbatches=microbatches)
    assert all(g.is_cuda and g.dtype == torch.bfloat16 for g in gg.values())
    assert all(bool(torch.isfinite(g).all()) for g in gg.values())
    errs = _grad_errors(gg, gc)
    assert max(errs.values()) <= GRAD_TOL, max(errs.items(), key=lambda kv: kv[1])
    before = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    step = train_loop.build_train_step(model, opt_lib.AdamWConfig(lr=1e-3, warmup_steps=1),
                                       microbatches=microbatches)
    _, _, mc = step(cpu, opt_lib.init_state(cpu), host)
    _, sg, mg = step(gpu, opt_lib.init_state(gpu), card)
    assert abs(float(mg["loss_total"]) - float(mc["loss_total"])) <= LM_TOL
    assert int(sg["step"]) == 1 and sg["m"]["embed"].is_cuda
    d1 = sum(float((p.detach() - before[n]).abs().sum()) for n, p in cpu.named_parameters())
    dd = sum(float((p.detach().cpu() - c.detach()).abs().sum())
             for p, c in zip(gpu.parameters(), cpu.parameters()))
    assert dd < 0.35 * d1, (dd, d1)


def test_checkpoint_card_to_host_and_back(lm_card, tmp_path):
    from repro_torch.train import checkpoint

    tree = {"w": torch.randn(5, 3, device=lm_card),
            "b": torch.randn(4, device=lm_card).to(torch.bfloat16),
            "step": torch.tensor(3, dtype=torch.int32, device=lm_card)}
    d = str(tmp_path / "ck")
    checkpoint.save(d, 3, tree)
    host = checkpoint.restore(d, 3, tree, device="cpu")
    for k, v in tree.items():
        assert host[k].device.type == "cpu" and torch.equal(host[k], v.cpu()), k
    checkpoint.save(d, 4, host)
    back = checkpoint.restore(d, 4, host, device=lm_card)
    for k, v in tree.items():
        assert back[k].is_cuda and torch.equal(back[k], v), k


def test_train_launcher_resumes_on_card(lm_card, tmp_path):
    """``launch.train.train`` on the card (its default device): a run
    stopped and resumed from its checkpoint replays the uninterrupted
    losses within the reference's ``rtol=2e-2``."""
    from repro_torch.launch.train import train

    kw = dict(smoke=True, steps=8, batch=4, seq=16, mesh_shape=(1,), log_every=100)
    d = str(tmp_path / "ck")
    full = train("qwen3-4b", **kw)
    train("qwen3-4b", **{**kw, "steps": 4}, ckpt_dir=d, ckpt_every=4)
    resumed = train("qwen3-4b", **kw, ckpt_dir=d, ckpt_every=100)
    np.testing.assert_allclose(resumed, full[4:], rtol=2e-2)
    assert full[-1] < full[0]


def test_serve_engine_records_no_graph_on_card(lm_card):
    """Serving trained parameters on the card: every logit the engine
    computes comes from ``inference_mode`` and carries no ``grad_fn``."""
    from repro_torch.configs import registry
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import ServeEngine

    cfg = registry.get_config("qwen3-4b", smoke=True)
    model = build_model(cfg)
    seen = []

    class Recording:
        def __getattr__(self, name):
            return getattr(model, name)

        def prefill(self, *a, **k):
            out = model.prefill(*a, **k)
            seen.append((torch.is_inference_mode_enabled(), out[0].grad_fn))
            return out

        def decode_logits(self, *a, **k):
            out = model.decode_logits(*a, **k)
            seen.append((torch.is_inference_mode_enabled(), out.grad_fn))
            return out

    params = model.trainable(model.init_params(seed=0, device=lm_card))
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_raw, (2, 8)).astype(np.int32)
    ServeEngine(Recording(), params=params).generate(prompts, 4)
    assert len(seen) == 4 and all(mode and fn is None for mode, fn in seen)


@pytest.mark.parametrize("window", [0, 100, 4096])
def test_sdpa_chunked_backward_on_card(lm_card, window):
    """The blockwise attention's dq, dk, dv on the card against the dense
    softmax's, for one cotangent (f32; ``atol=3e-5``)."""
    from repro_torch.models import attention

    rng = np.random.default_rng(0)
    s = 4100  # a padded last query and kv block
    q, k, v, w = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32) * sc)
                  .to(lm_card) for sh, sc in (((1, s, 4, 16), 0.3), ((1, s, 2, 16), 0.3),
                                              ((1, s, 2, 16), 1.0), ((1, s, 4, 16), 1.0)))
    i = torch.arange(s, device=lm_card)[:, None]
    j = torch.arange(s, device=lm_card)[None, :]
    mask = (j <= i) & ((j > i - window) if window else True)

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        fn(*leaves).backward(w)
        return [t.grad for t in leaves]

    chunked = grads(lambda q, k, v: attention._sdpa_chunked(q, k, v, 2, window=window))
    dense = grads(lambda q, k, v: attention._sdpa(q, k, v, mask[None], 2))
    for c, d in zip(chunked, dense):
        assert bool(torch.isfinite(c).all())
        torch.testing.assert_close(c, d, atol=3e-5, rtol=0)
