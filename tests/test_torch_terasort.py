"""Port parity of the mesh-scale external sort:
``repro_torch.core.terasort.sort_file_distributed`` on the CPU must write
the bytes (sha256) of ``repro.core.external.sort_file``.

* At world size 1 in this process (no process group): the reference's
  in-process cases of ``tests/test_terasort.py`` — cleanup on a forced
  overflow and on a final-pass failure, counter parity with the
  executor (and with the reference's counts), empty input, a manifest
  that serves the output — and the distributed differential of
  ``tests/test_differential.py`` (fixed/line × uniform/skewed ×
  host/mesh).
* Across 1, 4 and 8 gloo ranks, each job spawned with a ``file://``
  store under the test's directory and a hard timeout: uniform, skewed
  and duplicate-heavy gensort records, records whose 8-byte key prefix
  is all 0xFF (the words the router's padding carries), and line
  records with an unterminated last line, under the host and the mesh
  executors;
  partition counts against the reference's eager ``predict_bucket``;
  the same counts on every rank; one collective dispatch for the mesh
  executor; the servable v3 manifest; and at 8 ranks the sentinel-mask
  router regression of ``tests/test_terasort.py``.
"""

import hashlib
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.core import external as jext  # noqa: E402
from repro.core import rmi as jrmi  # noqa: E402
from repro.core import terasort as jterasort  # noqa: E402
from repro.core.format import LineFormat as JLineFormat  # noqa: E402
from repro.launch.mesh import make_data_mesh as jmesh  # noqa: E402
from repro_torch.core import encoding as tenc  # noqa: E402
from repro_torch.core import manifest as tman  # noqa: E402
from repro_torch.core import terasort, validate  # noqa: E402
from repro_torch.core.format import GENSORT, LineFormat  # noqa: E402
from repro_torch.data import gensort, lines  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.serve.index import SortedFileIndex  # noqa: E402

K = 16  # LineFormat key window, as in the reference's grids
N_FIXED, N_LINE = 6_000, 8_000
CHUNK = 2048
WORLDS = (1, 4, 8)
GLOO_CORPORA = ("fixed_uniform", "fixed_skewed", "fixed_dups", "fixed_ff",
                "line_uniform")
SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


def _sha(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _mesh():
    return tmesh.make_data_mesh(device="cpu")


def _write_corpus(path: str, name: str) -> None:
    fmt_kind, shape = name.split("_")
    if fmt_kind == "line":
        # plain "uniform" also drops the final newline: the sorter must
        # normalize it exactly as GNU sort does
        lines.write_lines(path, N_LINE, kind=shape, seed=5,
                          terminate_last=shape != "uniform")
    elif shape == "dups":
        # a 97-word key vocabulary: masses of full-key ties
        rec = gensort.make_records(N_FIXED, seed=11)
        vocab = gensort.uniform_keys(97, seed=99)
        rng = np.random.default_rng(17)
        rec[:, : gensort.KEY_BYTES] = vocab[rng.integers(0, 97, N_FIXED)]
        with open(path, "wb") as f:
            f.write(rec.tobytes())
    elif shape == "ff":
        # real keys with the padding's words: an 8-byte prefix of 0xFF
        # on 60 records (20 of them whole 10-byte 0xFF keys)
        rec = gensort.make_records(N_FIXED, seed=13)
        rows = np.random.default_rng(19).choice(N_FIXED, 60, replace=False)
        rec[rows, :8] = 0xFF
        rec[rows[:20], 8:10] = 0xFF
        with open(path, "wb") as f:
            f.write(rec.tobytes())
    else:
        gensort.write_file(path, N_FIXED, skewed=shape == "skewed", seed=3)


def _fmts(name: str):
    if name.startswith("line"):
        return LineFormat(max_key_bytes=K), JLineFormat(max_key_bytes=K)
    return GENSORT, None


_CORPORA: dict = {}


def _corpus(tmp_path_factory, name: str):
    """(input path, sha256 of the JAX ``sort_file`` output), once each."""
    if name not in _CORPORA:
        d = tmp_path_factory.mktemp(name)
        inp, ref = str(d / "in"), str(d / "jax.out")
        _write_corpus(inp, name)
        jext.sort_file(inp, ref, config=jext.SortConfig(fmt=_fmts(name)[1]))
        _CORPORA[name] = (inp, _sha(ref))
    return _CORPORA[name]


def _eager_counts(inp: str, name: str, n_dev: int) -> list:
    """Records per range under the reference's eager ``predict_bucket``
    and the model ``sort_file_distributed`` trains (its striped sample)."""
    keys = _fmts(name)[0].read_block(inp).keys
    n = keys.shape[0]
    idx = np.linspace(0, n - 1, min(max(int(n * 0.01), 4096), n)).astype(np.int64)
    model = jrmi.fit(np.ascontiguousarray(keys[idx]))
    hi, lo = tenc.encode_np(keys)
    b = np.asarray(jrmi.predict_bucket(model, jnp.asarray(hi), jnp.asarray(lo), n_dev))
    return np.bincount(b, minlength=n_dev).tolist()


# ---------------------------------------------------------------------------
# World size 1, in this process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("executor", ["host", "mesh"])
@pytest.mark.parametrize("shape", ["uniform", "skewed"])
@pytest.mark.parametrize("fmt_kind", ["fixed", "line"])
def test_distributed_differential(tmp_path_factory, tmp_path, fmt_kind, shape,
                                  executor):
    name = f"{fmt_kind}_{shape}"
    inp, jsha = _corpus(tmp_path_factory, name)
    fmt = _fmts(name)[0]
    out = str(tmp_path / "out.bin")
    n = fmt.read_block(inp).n_records
    stats = terasort.sort_file_distributed(
        inp, out, _mesh(), fmt=fmt,
        chunk_records=max(1024, n // 3),  # several chunks
        executor=executor, workdir=str(tmp_path), manifest=True,
    )
    assert _sha(out) == jsha
    assert stats.n_records == n
    assert stats.executor == executor
    assert validate.validate_file(
        out, validate.checksum_block(fmt.read_block(inp)), n, fmt=fmt
    )["ok"]
    assert stats.manifest_path and os.path.exists(stats.manifest_path)
    assert not [p for p in os.listdir(tmp_path) if p.startswith("terasort_")]


def test_cleanup_on_forced_overflow(tmp_path):
    """A chunk that overflows at 32x raises and leaves nothing behind."""
    inp = str(tmp_path / "in.bin")
    gensort.write_file(inp, 4096)
    out = str(tmp_path / "out.bin")
    work = tmp_path / "work"
    work.mkdir()
    with pytest.raises(RuntimeError, match="capacity overflow"):
        terasort.sort_file_distributed(
            inp, out, _mesh(), chunk_records=2048,
            capacity_factor=1e-9,  # capacity 1: guaranteed overflow
            workdir=str(work),
        )
    assert list(work.iterdir()) == [], "spill state leaked"
    assert not os.path.exists(out)


def test_cleanup_on_final_pass_failure(tmp_path, monkeypatch):
    """A failure after the output exists removes the partial output and
    clears the spill dir."""
    real = terasort.make_executor

    def broken(*args, **kwargs):
        ex = real(*args, **kwargs)

        def sort_iter(items):
            it = ex.__class__.sort_iter(ex, items)
            yield next(it)
            raise OSError("injected mid-sort failure")

        ex.sort_iter = sort_iter
        return ex

    monkeypatch.setattr(terasort, "make_executor", broken)
    inp = str(tmp_path / "in.bin")
    gensort.write_file(inp, 8192)
    out = str(tmp_path / "out.bin")
    work = tmp_path / "work"
    work.mkdir()
    with pytest.raises(OSError, match="injected"):
        terasort.sort_file_distributed(
            inp, out, _mesh(), chunk_records=2048, workdir=str(work)
        )
    assert list(work.iterdir()) == [], "spill state leaked"
    assert not os.path.exists(out), "partial output left looking sorted"


@pytest.mark.parametrize("executor", ["batched", "mesh"])
def test_counter_parity_with_executor(tmp_path, monkeypatch, executor):
    """The stats carry the executor's own dispatch, occupancy and shape
    counts, and they equal the reference's on a 1-device mesh."""
    captured = {}
    real = terasort.make_executor

    def spy(*args, **kwargs):
        ex = real(*args, **kwargs)
        captured["ex"] = ex
        return ex

    monkeypatch.setattr(terasort, "make_executor", spy)
    inp = str(tmp_path / "in.bin")
    gensort.write_file(inp, 20_000, seed=23)
    kw = dict(chunk_records=1 << 13, executor=executor, workdir=str(tmp_path))
    stats = terasort.sort_file_distributed(
        inp, str(tmp_path / "out.bin"), _mesh(), **kw
    )
    ex = captured["ex"]
    assert ex.dispatches > 0
    assert stats.device_dispatches == ex.dispatches
    assert stats.jit_compiles == ex.jit_compiles
    assert stats.batch_occupancy == pytest.approx(ex.occupancy)
    assert 0.0 < stats.batch_occupancy <= 1.0
    jstats = jterasort.sort_file_distributed(
        inp, str(tmp_path / "jax.bin"), jmesh(1), **kw
    )
    for f in ("device_dispatches", "jit_compiles", "batch_occupancy",
              "fallbacks", "bytes_read", "bytes_written", "partition_counts"):
        assert getattr(stats, f) == getattr(jstats, f), f


def test_empty_input(tmp_path):
    """Zero records: empty output, zero stats, no temp state."""
    inp = str(tmp_path / "in.bin")
    open(inp, "wb").close()
    out = str(tmp_path / "out.bin")
    work = tmp_path / "work"
    work.mkdir()
    stats = terasort.sort_file_distributed(
        inp, out, _mesh(), workdir=str(work)
    )
    assert stats.n_records == 0
    assert os.path.getsize(out) == 0
    assert list(work.iterdir()) == []


def test_manifest_serves_distributed_output(tmp_path):
    """``manifest=True``: a v3 manifest with the per-range counts and the
    reference's model hash, serving point lookups."""
    inp = str(tmp_path / "in.bin")
    n = 20_000
    gensort.write_file(inp, n, seed=31)
    out = str(tmp_path / "out.bin")
    stats = terasort.sort_file_distributed(
        inp, out, _mesh(), chunk_records=1 << 13, manifest=True
    )
    m = tman.load(stats.manifest_path)
    assert m.version == 3
    assert m.part_counts.tolist() == stats.partition_counts
    assert m.n_records == n
    jstats = jterasort.sort_file_distributed(
        inp, str(tmp_path / "jax.bin"), jmesh(1), chunk_records=1 << 13,
        manifest=True,
    )
    assert m.model_hash == tman.load(jstats.manifest_path).model_hash
    index = SortedFileIndex.open(out, device="cpu")
    recs = gensort.read_records(out, mmap=False)
    pick = np.unique(np.random.default_rng(3).integers(0, n, 64))
    rows, found = index.lookup(recs[pick, : gensort.KEY_BYTES])
    assert found.all()
    kv = validate.keys_view(recs)
    for i, r in zip(pick, rows):
        assert kv[int(r)] == kv[int(i)]


# ---------------------------------------------------------------------------
# 1, 4 and 8 gloo ranks, spawned
# ---------------------------------------------------------------------------

JOB = r"""
import json, os
import numpy as np, torch
from repro_torch.core import encoding, manifest, rmi, terasort
from repro_torch.core.format import GENSORT, LineFormat
from repro_torch.data import gensort
from repro_torch.launch import mesh as M
from repro_torch.serve.index import SortedFileIndex

M.initialize_multiprocess("file://" + os.environ["STORE"],
                          int(os.environ["WORLD_SIZE"]),
                          int(os.environ["RANK"]), device="cpu", timeout_s=60)
mesh = M.make_data_mesh(device="cpu")
d = os.environ["JOB_DIR"]
res = {"sorts": {}}
FIELDS = ("n_records", "bytes_read", "bytes_written", "partition_counts",
          "fallbacks", "device_dispatches", "jit_compiles", "batch_occupancy",
          "executor", "n_writers", "manifest_path")
for name, inp in json.loads(os.environ["CORPORA"]).items():
    fmt = LineFormat(max_key_bytes=16) if name.startswith("line") else GENSORT
    for ex in ("host", "mesh"):
        out = os.path.join(d, f"{name}.{ex}")
        st = terasort.sort_file_distributed(
            inp, out, mesh, fmt=fmt, chunk_records=int(os.environ["CHUNK"]),
            executor=ex, workdir=os.path.join(d, "spill"),
            manifest=name.startswith("line"),
        )
        res["sorts"][f"{name}.{ex}"] = {f: getattr(st, f) for f in FIELDS}

# the v3 manifest of the line output serves it
out = os.path.join(d, "line_uniform.mesh")
m = manifest.load(manifest.manifest_path(out))
index = SortedFileIndex.open(out, device="cpu")
probe = index.record_at(m.n_records // 2)[:-1]
rows, found = index.lookup(
    np.frombuffer(probe[:16].ljust(16, b"\x00"), np.uint8)[None, :])
res["manifest"] = {"version": m.version, "kind": m.fmt.kind,
                   "offsets": m.line_offsets is not None,
                   "found": bool(found[0]),
                   "same": index.record_at(int(rows[0]))[:-1] == probe}

if mesh.world_size == 8:
    # a short final chunk's SENTINEL pad rows must not consume bucket
    # capacity: 57 real + 7 pad rows, capacity route_capacity(20, 8, 1.6)
    # = 4, and every rank receiving exactly 4 last-bucket real rows
    sample = gensort.uniform_keys(4096, seed=5)
    model = rmi.fit(sample)
    order = np.argsort(np.ascontiguousarray(sample).view("S10").reshape(-1),
                       kind="stable")
    klow, khigh = sample[order[0]], sample[order[-1]]
    keys = np.empty((57, 10), np.uint8)
    cnt = np.zeros(8, int)
    for r in range(57):
        dst = r % 8  # the rank row r lands on after the block transpose
        keys[r] = khigh if cnt[dst] < 4 else klow
        cnt[dst] += 1
    hi, lo = encoding.encode_np(keys)
    words = np.full((2, 64), encoding.SENTINEL, dtype=np.int64)
    words[0, :57], words[1, :57] = hi, lo
    val = torch.arange(64, dtype=torch.int32)
    val[57:] = -1  # padding rows, as _stripe marks them
    s = slice(8 * mesh.rank, 8 * mesh.rank + 8)
    route = terasort._make_route_fn(mesh, model, 20, 1.6)
    ov, nv, lost = route(torch.from_numpy(words[0, s]),
                         torch.from_numpy(words[1, s]), val[s])
    rows = ov[: int(nv[0])].tolist()
    res["sentinel"] = {"lost": int(mesh.all_gather_ints([int(lost[0])]).sum()),
                       "rows": rows}
print("JOB " + json.dumps(res))
M.exit_rank()
"""

_JOBS: dict = {}


def _job(tmp_path_factory, world: int) -> list:
    """Every rank's results of the gloo job at ``world`` ranks, once."""
    if world not in _JOBS:
        corpora = {n: _corpus(tmp_path_factory, n)[0] for n in GLOO_CORPORA}
        d = tmp_path_factory.mktemp(f"gloo{world}")
        outs = tmesh.spawn(JOB, world, timeout_s=120, env={
            "STORE": str(d / "store"), "JOB_DIR": str(d),
            "CORPORA": json.dumps(corpora), "CHUNK": str(CHUNK),
            "PYTHONPATH": SRC,
        })
        ranks = [
            json.loads(next(line[4:] for line in o.splitlines()
                            if line.startswith("JOB ")))
            for o in outs
        ]
        _JOBS[world] = (d, ranks)
    return _JOBS[world]


@pytest.mark.parametrize("executor", ["host", "mesh"])
@pytest.mark.parametrize("name", GLOO_CORPORA)
@pytest.mark.parametrize("world", WORLDS)
def test_gloo_bytes_equal_jax(tmp_path_factory, world, name, executor):
    d, ranks = _job(tmp_path_factory, world)
    inp, jsha = _corpus(tmp_path_factory, name)
    assert _sha(d / f"{name}.{executor}") == jsha
    st = ranks[0]["sorts"][f"{name}.{executor}"]
    assert st["executor"] == executor
    assert st["partition_counts"] == _eager_counts(inp, name, world)
    if name in ("fixed_uniform", "fixed_skewed") and world > 1:
        c = np.array(st["partition_counts"])
        assert c.std() / c.mean() < 0.35, c  # equi-depth ranges


@pytest.mark.parametrize("world", WORLDS)
def test_gloo_every_rank_returns_the_same_counts(tmp_path_factory, world):
    d, ranks = _job(tmp_path_factory, world)
    assert len(ranks) == world
    for r in ranks[1:]:
        assert r["sorts"] == ranks[0]["sorts"]
    assert not os.listdir(d / "spill"), "spill state leaked"


@pytest.mark.parametrize("world", WORLDS)
def test_gloo_mesh_executor_one_collective_dispatch(tmp_path_factory, world):
    """One group dispatch covers every rank's range, as the reference's
    one ``shard_map`` launch does; the byte counters add up over ranks."""
    _, ranks = _job(tmp_path_factory, world)
    for name in GLOO_CORPORA:
        st = ranks[0]["sorts"][f"{name}.mesh"]
        assert st["device_dispatches"] == 1, name
        assert st["jit_compiles"] == 1, name
        assert 0.0 < st["batch_occupancy"] <= 1.0, name
        host = ranks[0]["sorts"][f"{name}.host"]
        assert host["device_dispatches"] == 0
        assert st["bytes_written"] == host["bytes_written"]
        assert st["bytes_read"] == host["bytes_read"]


@pytest.mark.parametrize("world", WORLDS)
def test_gloo_line_manifest_serves(tmp_path_factory, world):
    d, ranks = _job(tmp_path_factory, world)
    assert ranks[0]["manifest"] == {
        "version": 3, "kind": "line", "offsets": True, "found": True,
        "same": True,
    }
    st = ranks[0]["sorts"]["line_uniform.mesh"]
    m = tman.load(st["manifest_path"])
    assert m.part_counts.tolist() == st["partition_counts"]


def test_gloo_sentinel_router_regression(tmp_path_factory):
    """At 8 ranks, a short final chunk's SENTINEL pad rows go to the
    discard bucket: nothing is lost and every real row arrives once."""
    _, ranks = _job(tmp_path_factory, 8)
    assert all(r["sentinel"]["lost"] == 0 for r in ranks)
    got = sorted(row for r in ranks for row in r["sentinel"]["rows"])
    assert got == list(range(57))
