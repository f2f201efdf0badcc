"""The port's CUDA kernels and device path on a card: each kernel against
its plain PyTorch version, bit for bit, and the batched executor and
``sort_file`` on the card against the host executor's bytes.

Every test needs a CUDA device (a CUDA kernel has no CPU mode) and skips
without one; the check happens when the test runs.  This file imports
neither ``jax`` nor ``repro``, so it runs on a machine with the card
and PyTorch alone:

    python -m pytest -q tests/test_torch_cuda.py
"""

import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import external, rmi as trmi  # noqa: E402
from repro_torch.core.config import SortConfig  # noqa: E402
from repro_torch.core.executor import (  # noqa: E402
    BatchedDeviceExecutor,
    HostSortExecutor,
)
from repro_torch.core.format import GENSORT  # noqa: E402
from repro_torch.data import gensort  # noqa: E402
from repro_torch.kernels import bitonic, encode, ops, rmi  # noqa: E402


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


@pytest.mark.parametrize(
    "r,c,dups", [(1, 1, 3), (3, 2, 3), (7, 64, 3), (64, 1024, 3),
                 (64, 1024, 2**32 - 1), (2, 16384, 3)],
)
def test_bitonic_kernel_equals_plain(cuda, r, c, dups):
    args = [t.to(cuda) for t in _rows(r, c, dups)]
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
    assert [f.launches for f in ops.KERNEL_WRAPPERS] == [1, 1, 1]
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
    assert [f.launches for f in ops.KERNEL_WRAPPERS] == [ex.dispatches] * 3
    assert (ex.fallbacks >= 1) == dup


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
