"""Port parity: the ``repro_torch.kernels.ops`` wrappers against the JAX
package's Pallas kernels (interpret mode on the CPU) on the
``tests/test_kernels.py`` grids, at small sizes.

On the CPU each wrapper runs its kernel's plain PyTorch version.  The
CUDA kernels themselves are held against their plain versions in
``tests/test_torch_cuda.py``, which needs a card.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import encoding as jenc  # noqa: E402
from repro.core import rmi as jrmi  # noqa: E402
from repro.data import gensort  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import rmi as trmi  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402

SEN = 0xFFFFFFFF


def _i64(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


# ---------------------------------------------------------------------------
# CPU: wrappers (plain versions) against the JAX kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [256, 1025])
@pytest.mark.parametrize("width", [3, 8, 10, 16])
def test_encode_keys_matches_jax_kernel(n, width):
    rng = np.random.default_rng(n + width)
    keys = rng.integers(0, 256, size=(n, width), dtype=np.uint8)
    hi_j, lo_j = jops.encode_keys(jnp.asarray(keys))
    hi_t, lo_t = ops.encode_keys(torch.from_numpy(keys))
    np.testing.assert_array_equal(hi_t.numpy(), np.asarray(hi_j).astype(np.int64))
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j).astype(np.int64))


@pytest.mark.parametrize("n", [1024, 2500])
@pytest.mark.parametrize("n_leaf", [64, 1024])
@pytest.mark.parametrize("n_buckets", [16, 256])
@pytest.mark.parametrize("skewed", [False, True])
def test_rmi_bucket_matches_jax_kernel(n, n_leaf, n_buckets, skewed):
    keys = (
        gensort.skewed_keys(n, seed=n) if skewed
        else gensort.uniform_keys(n, seed=n)
    )
    model = jrmi.fit(keys[: n // 2], n_leaf=n_leaf)
    hi, lo = jenc.encode_np(keys)
    want = np.asarray(
        jops.rmi_bucket(model, jnp.asarray(hi), jnp.asarray(lo), n_buckets)
    )
    got = ops.rmi_bucket(
        trmi.params_from_numpy(model), _i64(hi), _i64(lo), n_buckets
    )
    np.testing.assert_array_equal(got.numpy(), want)


def _rows(r, c, dup_range):
    rng = np.random.default_rng(r * c)
    hi = rng.integers(0, dup_range, size=(r, c)).astype(np.uint32)
    lo = rng.integers(0, 5, size=(r, c)).astype(np.uint32)
    val = np.tile(np.arange(c, dtype=np.int32), (r, 1))
    return hi, lo, val


@pytest.mark.parametrize("r", [1, 4, 7, 13, 16])
@pytest.mark.parametrize("c", [2, 64, 128, 100, 257])
@pytest.mark.parametrize("dup_range", [3, 2**32 - 1])
def test_sort_rows_matches_reference_order(r, c, dup_range):
    """(hi, lo) equal to the reference's stable row sort; ``val`` ordered
    by the strict (hi, lo, val) tiebreak, a permutation of each row."""
    hi, lo, val = _rows(r, c, dup_range)
    hr, lr, vr = jref.sort_rows_ref(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(val)
    )
    hk, lk, vk = ops.sort_rows(_i64(hi), _i64(lo), torch.from_numpy(val))
    np.testing.assert_array_equal(hk.numpy(), np.asarray(hr).astype(np.int64))
    np.testing.assert_array_equal(lk.numpy(), np.asarray(lr).astype(np.int64))
    # val ascends inside each run of equal keys: the reference's stable
    # sort kept the ascending input order, so the payloads agree too
    np.testing.assert_array_equal(vk.numpy(), np.asarray(vr))
    th, tl, tv = ref.sort_rows_ref(_i64(hi), _i64(lo), torch.from_numpy(val))
    assert torch.equal(th, hk) and torch.equal(tl, lk) and torch.equal(tv, vk)


@pytest.mark.parametrize("r,c", [(1, 2), (7, 64), (13, 100)])
@pytest.mark.parametrize("dup_range", [3, 2**32 - 1])
def test_sort_rows_matches_jax_bitonic(r, c, dup_range):
    """Against the Pallas bitonic kernel itself: the strict (hi, lo, val)
    order makes the result unique, payloads included."""
    hi, lo, val = _rows(r, c, dup_range)
    val = np.ascontiguousarray(val[:, ::-1])  # ties now need the val order
    hj, lj, vj = jops.sort_rows(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(val))
    hk, lk, vk = ops.sort_rows(_i64(hi), _i64(lo), torch.from_numpy(val))
    np.testing.assert_array_equal(hk.numpy(), np.asarray(hj).astype(np.int64))
    np.testing.assert_array_equal(lk.numpy(), np.asarray(lj).astype(np.int64))
    np.testing.assert_array_equal(vk.numpy(), np.asarray(vj))


def test_bitonic_sentinel_padding_loses_ties():
    """Real records with sentinel keys must beat width-padding slots."""
    hi = torch.full((1, 100), SEN, dtype=torch.int64)
    lo = torch.full((1, 100), SEN, dtype=torch.int64)
    val = torch.arange(100, dtype=torch.int32)[None, :]
    _, _, vk = ops.sort_rows(hi, lo, val)
    assert vk[0].tolist() == list(range(100))


def test_wrappers_count_only_kernel_launches():
    """The CPU path runs the plain versions and launches nothing."""
    ops.reset_launches()
    keys = torch.from_numpy(gensort.uniform_keys(64, seed=1))
    hi, lo = ops.encode_keys(keys)
    model = trmi.fit(gensort.uniform_keys(512, seed=2), n_leaf=16)
    ops.rmi_bucket(model, hi, lo, 16)
    ops.sort_rows(hi.reshape(8, 8), lo.reshape(8, 8),
                  torch.arange(64, dtype=torch.int32).reshape(8, 8))
    ops.bucket_histogram(torch.arange(64, dtype=torch.int32) % 5, 4)
    ops.encode_full_keys(keys)
    assert [f.launches for f in ops.KERNEL_WRAPPERS] == [0, 0, 0, 0, 0]


def test_no_path_for_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA device has no
    kernel and no plain fallback: the wrapper raises."""
    keys = torch.empty((4, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        ops.encode_keys(keys)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that fails makes the first CUDA use raise."""
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.library()
    assert not list(tmp_path.glob("*.so"))


def test_build_keeps_ptxas_lines_beside_the_library(tmp_path, monkeypatch):
    """Each source's ptxas register and spill lines are kept beside the
    built library, so a later load of the cached library reports them."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        'while [ $# -gt 0 ] && [ "$1" != "-o" ]; do shift; done\n'
        ': > "$2"\n'
        'echo "ptxas info    : Used 133 registers, used 0 barriers"\n'
        'echo "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"\n'
        'echo "unrelated"\n'
    )
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    so = tmp_path / "lib.so"
    ptxas = build._compile(so)
    assert so.exists()
    assert sorted(ptxas) == sorted(build.SOURCES)
    for lines in ptxas.values():
        assert lines == [
            "ptxas info    : Used 133 registers, used 0 barriers",
            "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        ]
    assert json.loads(build._ptxas_path(so).read_text()) == ptxas
