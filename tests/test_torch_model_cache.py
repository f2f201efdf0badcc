"""Port parity of the warm-start model cache and the mergesort baseline.

``repro_torch.core.model_cache.ModelCache`` through ``sort_file(
model_cache=..., device="cpu")`` must take the reference's hit/miss
decisions, report the reference's ``model_hash`` and write the
reference's bytes (a cache hit included); a hit must reuse the device
copy of the cached model rather than upload it again.
``repro_torch.core.mergesort.sort_file`` must write the bytes of
``repro.core.mergesort.sort_file``, which are the learned sort's.
"""

import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import external as jext  # noqa: E402
from repro.core import mergesort as jmerge  # noqa: E402
from repro.core import rmi as jrmi  # noqa: E402
from repro.core.model_cache import ModelCache as JModelCache  # noqa: E402
from repro.data import gensort  # noqa: E402
from repro_torch.core import external as text  # noqa: E402
from repro_torch.core import manifest as tman  # noqa: E402
from repro_torch.core import mergesort as tmerge  # noqa: E402
from repro_torch.core import rmi as trmi  # noqa: E402
from repro_torch.core.config import SortConfig  # noqa: E402
from repro_torch.core.model_cache import ModelCache  # noqa: E402

N = 8_000
KNOBS = dict(memory_budget_bytes=2 << 20, batch_records=4_000)


def _sha(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """A uniform corpus and one drifted into a narrow key slice (the
    uniform model's CDF is flat there, so the band check fails)."""
    d = tmp_path_factory.mktemp("mc")
    uniform, drift = str(d / "uniform.bin"), str(d / "drift.bin")
    gensort.write_file(uniform, N, seed=11)
    rec = gensort.make_records(N, seed=3)
    rec[:, :6] = 0xFE
    rec.tofile(drift)
    return uniform, drift


def _run(package, corpora, tmp_path):
    """Sort uniform, uniform, drift, drift with one cache; returns the
    per-sort (outcome, hash, output sha) and the cache's totals."""
    uniform, drift = corpora
    if package == "jax":
        cache = JModelCache()
        sort = lambda i, o, **kw: jext.sort_file(  # noqa: E731
            i, o, config=jext.SortConfig(model_cache=cache, **KNOBS, **kw)
        )
    else:
        cache = ModelCache()
        sort = lambda i, o, **kw: text.sort_file(  # noqa: E731
            i, o, config=SortConfig(
                model_cache=cache, device="cpu", **KNOBS, **kw
            )
        )
    runs = []
    for k, (inp, kw) in enumerate([(uniform, {}), (uniform, {}),
                                   (drift, {"n_partitions": 8}),
                                   (drift, {"n_partitions": 8})]):
        out = str(tmp_path / f"{package}{k}.bin")
        st = sort(inp, out, **kw)
        runs.append((st.model_cache, st.model_hash, _sha(out)))
    return runs, (cache.hits, cache.misses, len(cache))


def test_cache_outcomes_hashes_and_bytes_equal_jax(corpora, tmp_path):
    want, want_totals = _run("jax", corpora, tmp_path)
    got, got_totals = _run("torch", corpora, tmp_path)
    assert [r[0] for r in want] == ["miss", "hit", "miss", "hit"]
    assert got == want
    assert got_totals == want_totals == (2, 2, 2)
    assert got[0][1] == got[1][1] != got[2][1] == got[3][1]
    # a cache-hit sort writes the bytes a fresh-trained sort writes
    fresh = str(tmp_path / "fresh.bin")
    st = text.sort_file(corpora[0], fresh,
                        config=SortConfig(device="cpu", **KNOBS))
    assert (st.model_cache, st.model_hash) == ("", "")
    assert _sha(fresh) == got[1][2]


@pytest.mark.parametrize("executor", ["batched", "per_partition"])
def test_cache_hit_bytes_equal_across_executors(corpora, tmp_path, executor):
    cache = ModelCache()
    shas = []
    for k, ex in enumerate(["host", executor]):
        out = str(tmp_path / f"{k}.bin")
        st = text.sort_file(corpora[0], out, config=SortConfig(
            model_cache=cache, device="cpu", executor=ex, use_kernels=True,
            **KNOBS,
        ))
        assert st.model_cache == ("miss", "hit")[k] and st.executor == ex
        shas.append(_sha(out))
    assert shas[0] == shas[1]


def test_store_lookup_lru_equal_jax():
    """store() dedups by the reference's hash and evicts the LRU entry;
    lookups pick the MRU trusted model, as in the reference."""
    jmodels = [
        jrmi.fit(gensort.uniform_keys(2_000, seed=s), n_leaf=16)
        for s in range(3)
    ]
    jcache, tcache = JModelCache(max_entries=2), ModelCache(max_entries=2)
    for jm in jmodels + jmodels[:1]:
        tm = trmi.params_from_numpy(jm)
        assert tcache.store(tm) == jcache.store(jm) == tman.model_hash(tm)
    assert len(tcache) == len(jcache) == 2
    sample = gensort.uniform_keys(1_000, seed=9)
    (tm, th), (jm, jh) = tcache.lookup(sample, 4), jcache.lookup(sample, 4)
    assert th == jh and tm is not None
    empty = np.empty((0, 10), dtype=np.uint8)
    assert tcache.lookup(empty, 4) == (None, "")
    assert (tcache.hits, tcache.misses) == (jcache.hits, jcache.misses + 1)


def test_cached_model_uploads_once_per_device():
    """``RMIParams.to`` keeps its copy: a cache hit hands the executor
    the model whose device copy (and packed kernel table) the first
    sort made, so nothing is uploaded again."""
    model = trmi.fit(gensort.uniform_keys(2_000, seed=1), n_leaf=16)
    assert model.to("cpu") is model
    copy = model.to("meta")
    assert copy is model.to("meta") and copy.device.type == "meta"
    assert copy.to("meta") is copy
    assert tman.model_hash(model) == tman.model_hash(
        trmi.params_from_numpy(trmi.to_numpy(model))
    )


def test_mergesort_bytes_equal_jax(tmp_path):
    inp = str(tmp_path / "in.bin")
    gensort.write_file(inp, 6_000, skewed=True, seed=5)
    outs = {}
    for name, mod in (("jax", jmerge), ("torch", tmerge)):
        outs[name] = str(tmp_path / f"{name}.bin")
        st = mod.sort_file(inp, outs[name], memory_budget_bytes=200_000,
                           workdir=str(tmp_path))
        assert st.n_records == 6_000
        assert set(st.phase_seconds) == {"run_create", "merge"}
        assert st.bytes_written == 2 * 6_000 * gensort.RECORD_BYTES
    learned = str(tmp_path / "learned.bin")
    text.sort_file(inp, learned, config=SortConfig(device="cpu"))
    assert _sha(outs["torch"]) == _sha(outs["jax"]) == _sha(learned)
