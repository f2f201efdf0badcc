"""Port parity of the serving manifest: ``repro_torch`` ``sort_file(
manifest=True, device="cpu")`` and the JAX package's, on the same input,
must write equal manifests — version, counts, boundary keys, error band,
the model's arrays and ``model_hash`` — and each package must load the
other's ``.npz``.  Plus the version policy (v1/v2 load with a recomputed
hash, unknown versions are refused) and the empty-input manifest of a
shared-model sort.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import external as jext, manifest as jman  # noqa: E402
from repro.core import rmi as jrmi  # noqa: E402
from repro.core.config import SortConfig as JSortConfig  # noqa: E402
from repro.data import gensort  # noqa: E402
from repro_torch.core import external as text, manifest as tman  # noqa: E402
from repro_torch.core import rmi as trmi  # noqa: E402
from repro_torch.core.config import SortConfig  # noqa: E402

N = 6_000
KNOBS = dict(memory_budget_bytes=1 << 20, n_partitions=8, manifest=True)
_MODEL_FIELDS = [f.name for f in dataclasses.fields(trmi.RMIParams)]


def _write_lines(path, n, seed=7):
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        for i in range(n):
            f.write(b"%012d v%s\n" % (rng.integers(10**9), b"x" * int(i % 5)))


def _model_arrays(model) -> dict:
    """The model's fields as NumPy arrays, from either package."""
    if isinstance(model, trmi.RMIParams):
        model = trmi.to_numpy(model)
    return {f: np.asarray(getattr(model, f)) for f in _MODEL_FIELDS}


def assert_manifests_equal(t, j):
    assert (t.version, t.n_records, t.err_lo, t.err_hi) == (
        j.version, j.n_records, j.err_lo, j.err_hi,
    )
    np.testing.assert_array_equal(t.part_counts, j.part_counts)
    np.testing.assert_array_equal(t.boundary_keys, j.boundary_keys)
    assert t.boundary_keys.dtype == j.boundary_keys.dtype == np.uint8
    assert t.model_hash == j.model_hash
    assert t.fmt.manifest_fields().keys() == j.fmt.manifest_fields().keys()
    for k, v in t.fmt.manifest_fields().items():
        np.testing.assert_array_equal(v, j.fmt.manifest_fields()[k])
    if j.line_offsets is None:
        assert t.line_offsets is None
    else:
        np.testing.assert_array_equal(t.line_offsets, j.line_offsets)
    tm, jm = _model_arrays(t.model), _model_arrays(j.model)
    for f in _MODEL_FIELDS:
        assert tm[f].dtype == jm[f].dtype, f
        np.testing.assert_array_equal(tm[f], jm[f], err_msg=f)


_CACHE: dict = {}


def _sorted_pair(tmp_path_factory, kind):
    """(port output, JAX output) of one input, each with its manifest."""
    if kind not in _CACHE:
        d = tmp_path_factory.mktemp(f"manifest_{kind}")
        inp = str(d / "in.bin")
        knobs = dict(KNOBS)
        if kind == "line":
            _write_lines(inp, N)
            knobs["fmt"] = "line"
        else:
            gensort.write_file(inp, N, skewed=kind == "skewed", seed=5)
        jout, tout = str(d / "jax.bin"), str(d / "torch.bin")
        jstats = jext.sort_file(inp, jout, JSortConfig(**knobs))
        tstats = text.sort_file(inp, tout, SortConfig(device="cpu", **knobs))
        _CACHE[kind] = (tout, tstats, jout, jstats)
    return _CACHE[kind]


@pytest.mark.parametrize("kind", ["uniform", "skewed", "line"])
def test_manifest_equals_jax(tmp_path_factory, kind):
    tout, tstats, jout, jstats = _sorted_pair(tmp_path_factory, kind)
    with open(tout, "rb") as a, open(jout, "rb") as b:
        assert a.read() == b.read()
    assert tstats.manifest_path == tman.manifest_path(tout)
    assert os.path.exists(tstats.manifest_path)
    assert "manifest" in tstats.phase_seconds
    t = tman.load(tman.manifest_path(tout))
    j = jman.load(jman.manifest_path(jout))
    assert_manifests_equal(t, j)
    assert t.model_hash == tman.model_hash(t.model)
    assert int(t.part_counts.sum()) == t.n_records == N


@pytest.mark.parametrize("kind", ["uniform", "line"])
def test_each_package_loads_the_others_manifest(tmp_path_factory, kind):
    tout, _, jout, _ = _sorted_pair(tmp_path_factory, kind)
    tpath, jpath = tman.manifest_path(tout), jman.manifest_path(jout)
    j_by_t = tman.load(jpath)  # the port reads the JAX file
    t_by_j = jman.load(tpath)  # the JAX package reads the port's
    assert_manifests_equal(j_by_t, jman.load(jpath))
    assert_manifests_equal(tman.load(tpath), t_by_j)
    assert tman.model_hash(j_by_t.model) == jman.model_hash(t_by_j.model)
    # the two files hold the same arrays under the same names and dtypes
    with np.load(tpath) as zt, np.load(jpath) as zj:
        assert sorted(zt.files) == sorted(zj.files)
        for k in zt.files:
            assert zt[k].dtype == zj[k].dtype, k
            np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)


def test_save_load_roundtrip_and_version_policy(tmp_path_factory, tmp_path):
    tout, _, _, _ = _sorted_pair(tmp_path_factory, "uniform")
    mpath = tman.manifest_path(tout)
    m = tman.load(mpath)
    assert m.version == tman.MANIFEST_VERSION == jman.MANIFEST_VERSION
    copy = str(tmp_path / "copy.npz")
    tman.save(m, copy)
    assert_manifests_equal(tman.load(copy), m)
    with np.load(mpath) as z:
        payload = {k: z[k] for k in z.files}
    # v2 predates the stored hash, v1 also the format fields: both load,
    # in either package, with the hash recomputed from the model arrays
    v2 = {k: v for k, v in payload.items() if k != "model_hash"}
    v2["version"] = np.int64(2)
    v1 = {k: v for k, v in v2.items() if not k.startswith("fmt_")}
    v1["version"] = np.int64(1)
    for version, fields in ((2, v2), (1, v1)):
        path = str(tmp_path / f"v{version}.npz")
        with open(path, "wb") as fh:
            np.savez(fh, **fields)
        old = tman.load(path)
        assert old.version == version
        assert old.model_hash == m.model_hash == jman.load(path).model_hash
        assert (old.fmt.record_bytes, old.fmt.key_bytes) == (100, 10)
    bad = str(tmp_path / "bad.npz")
    payload["version"] = np.int64(tman.MANIFEST_VERSION + 1)
    with open(bad, "wb") as fh:
        np.savez(fh, **payload)
    with pytest.raises(ValueError, match="format version"):
        tman.load(bad)


def test_empty_input_manifest(tmp_path):
    """An empty input sorted under a pre-trained model gets a manifest of
    n_partitions zero counts (co-partition alignment), equal to the JAX
    one; without a model there is nothing to index and no manifest."""
    jmodel = jrmi.fit(gensort.uniform_keys(2000, seed=1), n_leaf=16)
    tmodel = trmi.params_from_numpy(jmodel)
    inp = str(tmp_path / "empty.bin")
    open(inp, "wb").close()
    jout, tout = str(tmp_path / "jax.bin"), str(tmp_path / "torch.bin")
    jext.sort_file(inp, jout, JSortConfig(model=jmodel, **KNOBS))
    tstats = text.sort_file(
        inp, tout, SortConfig(model=tmodel, device="cpu", **KNOBS)
    )
    assert tstats.partition_counts == [0] * KNOBS["n_partitions"]
    t = tman.load(tman.manifest_path(tout))
    assert_manifests_equal(t, jman.load(jman.manifest_path(jout)))
    assert t.n_records == 0 and (t.err_lo, t.err_hi) == (0, 0)
    assert (t.boundary_keys == 0xFF).all()
    bare = str(tmp_path / "bare.bin")
    stats = text.sort_file(inp, bare, SortConfig(device="cpu", **KNOBS))
    assert stats.manifest_path is None
    assert not os.path.exists(tman.manifest_path(bare))
