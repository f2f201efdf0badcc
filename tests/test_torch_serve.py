"""Port parity of serving: the port's ``SortedFileIndex``, ``QueryEngine``
and in-process ``QueryServer`` (``device="cpu"``) must answer exactly as
the JAX package's over the same sorted file and manifest — the
``tests/test_query.py`` workload (points at batch sizes 1 and 64, ranges,
the forced ``err_lo = err_hi = 0`` fallback) — and its predictions must be
bit-equal to the JAX eager ``rmi.predict_bucket`` at ``n_buckets = n``
(``use_kernels=True``: the RMI kernel's plain version) and to the JAX
NumPy predictor (``use_kernels=False``).  Plus the scheduler's FIFO,
shedding and drain, the cache's byte identity and the router's routing,
at the sizes of ``tests/test_serve.py``.
"""

import asyncio
import dataclasses
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import config as jconfig, external as jext  # noqa: E402
from repro.core import encoding as jenc, rmi as jrmi  # noqa: E402
from repro.core.stages.stats import LatencyReservoir as JReservoir  # noqa: E402
from repro.data import gensort  # noqa: E402
from repro.serve.index import SortedFileIndex as JIndex  # noqa: E402
from repro.serve.query_engine import QueryEngine as JEngine  # noqa: E402
from repro.serve.server import QueryServer as JServer  # noqa: E402
from repro_torch.core import config as tconfig, external as text  # noqa: E402
from repro_torch.core import manifest as tman  # noqa: E402
from repro_torch.core.stages.stats import (  # noqa: E402
    LatencyReservoir,
    ServeStats,
)
from repro_torch.launch import query as tquery  # noqa: E402
from repro_torch.serve.cache import PartitionBlockCache  # noqa: E402
from repro_torch.serve.index import SortedFileIndex  # noqa: E402
from repro_torch.serve.query_engine import QueryEngine  # noqa: E402
from repro_torch.serve.router import ShardRouter  # noqa: E402
from repro_torch.serve.scheduler import (  # noqa: E402
    FifoBatchScheduler,
    Overloaded,
)
from repro_torch.serve.server import QueryServer  # noqa: E402

N = 100_000  # tests/test_query.py
N_SERVE = 8_000  # tests/test_serve.py


def _rec_bytes(rec):
    return rec if isinstance(rec, bytes) else np.ascontiguousarray(rec).tobytes()


# ---------------------------------------------------------------------------
# the tests/test_query.py workload over one file sorted by the JAX package
# ---------------------------------------------------------------------------


class _Case:
    def __init__(self, tmp, skewed):
        inp = os.path.join(tmp, "in.bin")
        self.out = os.path.join(tmp, "out.bin")
        gensort.write_file(inp, N, skewed=skewed)
        jext.sort_file(
            inp, self.out,
            jconfig.SortConfig(memory_budget_bytes=16 << 20, n_readers=2,
                               manifest=True),
        )
        recs = gensort.read_records(self.out, mmap=False)
        rng = np.random.default_rng(3)
        present = recs[rng.choice(N, 300, replace=False), :10]
        absent = gensort.uniform_keys(100, seed=1234)
        self.queries = np.concatenate([present, absent])
        rng.shuffle(self.queries, axis=0)
        keys = np.ascontiguousarray(recs[:, :10]).view("S10").reshape(-1)
        self.ranges = []
        for _ in range(20):
            a, b = np.sort(rng.choice(N, 2, replace=False))
            self.ranges.append((keys[a].tobytes(), keys[b].tobytes()))
        self.ranges.append((b"\x20" * 10, b"\x7e" * 10))
        self.ranges.append((b"~~~~~~~~~~", b"~~~~~~~~~~"))
        # keys of the file itself, for the prediction checks
        self.file_keys = recs[rng.choice(N, 4000, replace=False), :10]


@pytest.fixture(scope="module", params=[False, True], ids=["uniform", "skewed"])
def case(request, tmp_path_factory):
    return _Case(str(tmp_path_factory.mktemp("tquery")), request.param)


def _run_engine(engine, case, batch):
    points = [
        engine.point(case.queries[i : i + batch])
        for i in range(0, case.queries.shape[0], batch)
    ]
    return points, engine.range(case.ranges)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("batch", [1, 64])
def test_engine_answers_equal_jax(case, batch, use_kernels):
    tindex = SortedFileIndex.open(case.out, device="cpu")  # JAX manifest
    jindex = JIndex.open(case.out)
    with QueryEngine(tindex, n_workers=2, use_kernels=use_kernels) as teng:
        tpoints, tranges = _run_engine(teng, case, batch)
    with JEngine(jindex, n_workers=2) as jeng:
        jpoints, jranges = _run_engine(jeng, case, batch)
    for (trec, trow, tfound), (jrec, jrow, jfound) in zip(tpoints, jpoints):
        np.testing.assert_array_equal(trow, jrow)
        np.testing.assert_array_equal(tfound, jfound)
        np.testing.assert_array_equal(trec, jrec)
    for t, j in zip(tranges, jranges):
        np.testing.assert_array_equal(t, j)
    assert teng.stats.n_point == jeng.stats.n_point == case.queries.shape[0]
    assert teng.stats.n_range == jeng.stats.n_range == len(case.ranges)
    assert teng.stats.n_hits == jeng.stats.n_hits
    assert teng.stats.records_scanned == jeng.stats.records_scanned
    assert teng.stats.qps > 0
    assert tindex.observed_err_lo <= tindex.manifest.err_lo
    assert tindex.observed_err_hi <= tindex.manifest.err_hi
    tindex.close()
    jindex.close()


def test_forced_fallback_equals_jax(case):
    """err band 0: every banded search provably misses; the boundary-key
    fallback answers, and both packages count the same fallbacks."""
    tm = tman.load(tman.manifest_path(case.out))
    tindex = SortedFileIndex(
        case.out, dataclasses.replace(tm, err_lo=0, err_hi=0), device="cpu"
    )
    jm = JIndex.open(case.out).manifest
    jindex = JIndex(case.out, dataclasses.replace(jm, err_lo=0, err_hi=0))
    q = case.queries[:64]
    for a, b in zip(tindex.lookup(q), jindex.lookup(q)):
        np.testing.assert_array_equal(a, b)
    for lo, hi in case.ranges[:5]:
        np.testing.assert_array_equal(
            tindex.range_scan(lo, hi), jindex.range_scan(lo, hi)
        )
    assert tindex.fallbacks == jindex.fallbacks > 0
    assert tindex.band_hits == jindex.band_hits


def test_predictions_bit_equal(case):
    """use_kernels=True: the RMI kernel's plain version at n_buckets = n
    equals the JAX eager ``rmi.predict_bucket`` (not the jitted
    ``ops.rmi_predict_pos``, which FMA-contracts: ROADMAP hazard b);
    use_kernels=False: the NumPy float64 predictor equals the JAX one."""
    tindex = SortedFileIndex.open(case.out, device="cpu")
    jindex = JIndex.open(case.out)
    keys = np.concatenate([case.queries, case.file_keys])
    hi, lo = jenc.encode_np(keys)
    eager = np.asarray(
        jrmi.predict_bucket(
            jindex.manifest.model, jnp.asarray(hi), jnp.asarray(lo), N
        )
    ).astype(np.int64)
    np.testing.assert_array_equal(
        tindex.predict_positions(keys, use_kernels=True),
        np.clip(eager, 0, N - 1),
    )
    np.testing.assert_array_equal(
        tindex.predict_positions(keys, use_kernels=False),
        jindex.predict_positions(keys, use_kernels=False),
    )


def test_cuda_index_without_a_card_raises(case):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SortedFileIndex.open(case.out)  # device="cuda" by default


# ---------------------------------------------------------------------------
# server, scheduler, cache, router: tests/test_serve.py sizes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["fixed", "line"])
def sorted_case(request, tmp_path_factory):
    """One file per format, sorted by the port (its own manifest)."""
    tmp = str(tmp_path_factory.mktemp(f"tserve_{request.param}"))
    inp = os.path.join(tmp, "in.bin")
    out = os.path.join(tmp, "out.bin")
    cfg = tconfig.SortConfig(manifest=True, n_partitions=16, device="cpu")
    if request.param == "fixed":
        gensort.write_file(inp, N_SERVE, skewed=False)
    else:
        rng = np.random.default_rng(7)
        with open(inp, "wb") as f:
            for i in range(N_SERVE):
                f.write(b"%012d v%s\n"
                        % (rng.integers(10**9), b"x" * int(i % 5)))
        cfg = cfg.replace(fmt="line")
    text.sort_file(inp, out, cfg)
    index = SortedFileIndex.open(out, device="cpu")
    yield index
    index.close()


def _sample_keys(index, n, seed=0):
    rng = np.random.default_rng(seed)
    rows = rng.choice(index.n, size=n, replace=True)
    return [k.tobytes() for k in index.keys_at(rows)]


async def _serve(server, keys, ranges):
    await server.start()
    points = await asyncio.gather(*[server.point(k) for k in keys])
    scans = [await server.range_scan(lo, hi) for lo, hi in ranges]
    await server.stop()
    return points, scans


@pytest.mark.parametrize("use_kernels", [False, True])
def test_server_in_process_equals_jax(sorted_case, use_kernels):
    index = sorted_case
    keys = _sample_keys(index, 60, seed=3) + [b"\x7f" * index.key_width] * 6
    ranges = [(min(keys[:60]), max(keys[:60])),
              (index.min_key(), index.max_key())]
    tcfg = tconfig.ServeConfig(max_batch=16, max_wait_ms=1.0, host="",
                               device="cpu", use_kernels=use_kernels)
    jcfg = jconfig.ServeConfig(max_batch=16, max_wait_ms=1.0, host="")
    tserver = QueryServer(index, tcfg, own_indexes=False)
    jindex = JIndex.open(index.path)  # the JAX package reads the port's
    jserver = JServer(jindex, jcfg)
    tpoints, tscans = asyncio.run(_serve(tserver, keys, ranges))
    jpoints, jscans = asyncio.run(_serve(jserver, keys, ranges))
    assert all(p["ok"] for p in tpoints + tscans)
    assert tpoints == jpoints
    assert tscans == jscans
    assert sum(p["found"] for p in tpoints) == 60
    assert tserver.stats.n_point == len(keys)
    assert tserver.stats.n_range == len(ranges)


def test_scheduler_fifo_across_batches():
    async def go():
        sched = FifoBatchScheduler(max_batch=3, max_wait_s=0.01)
        for i in range(10):
            sched.submit("point", i)
        seen = []
        while len(seen) < 10:
            seen += [r.payload for r in await sched.next_batch()]
        assert seen == list(range(10))

    asyncio.run(go())


def test_scheduler_dispatches_partial_batch_at_max_wait():
    async def go():
        sched = FifoBatchScheduler(max_batch=64, max_wait_s=0.05)
        sched.submit("point", "lonely")
        t0 = time.monotonic()
        batch = await sched.next_batch()
        dt = time.monotonic() - t0
        assert len(batch) == 1 and 0.04 <= dt < 5.0

    asyncio.run(go())


def test_scheduler_sheds_beyond_queue_bound():
    async def go():
        stats = ServeStats()
        sched = FifoBatchScheduler(
            max_batch=4, max_wait_s=0.01, max_queue=5, stats=stats
        )
        for i in range(5):
            sched.submit("point", i)
        with pytest.raises(Overloaded) as exc:
            sched.submit("point", 99)
        assert exc.value.depth == 5 and exc.value.bound == 5
        assert stats.n_shed == 1
        batch = await sched.next_batch()
        assert [r.payload for r in batch] == [0, 1, 2, 3]

    asyncio.run(go())


def test_scheduler_close_drains_then_signals_none():
    async def go():
        sched = FifoBatchScheduler(max_batch=2, max_wait_s=0.01)
        for i in range(3):
            sched.submit("point", i)
        sched.close()
        with pytest.raises(RuntimeError):
            sched.submit("point", 99)
        assert len(await sched.next_batch()) == 2
        assert len(await sched.next_batch()) == 1
        assert await sched.next_batch() is None

    asyncio.run(go())


def test_server_graceful_drain_and_shed(sorted_case):
    """Drain answers every admitted request; beyond the queue bound the
    server sheds instead of queueing."""
    index = sorted_case
    keys = _sample_keys(index, 200, seed=5)

    async def go():
        cfg = tconfig.ServeConfig(max_batch=8, max_wait_ms=50.0,
                                  queue_bound=16, host="", device="cpu")
        server = await QueryServer(index, cfg, own_indexes=False).start()
        ok, shed = [], 0
        for k in keys:
            try:
                ok.append(server.scheduler.submit("point", k))
            except Overloaded:
                shed += 1
        stop = asyncio.create_task(server.stop(drain=True))
        results = await asyncio.gather(*ok)
        await stop
        return results, shed, server.stats

    results, shed, stats = asyncio.run(go())
    assert shed > 0 and stats.n_shed == shed
    assert len(results) + shed == len(keys)
    assert all(r["ok"] and r["found"] for r in results)


def test_cache_byte_identity(sorted_case):
    index = sorted_case
    stats = ServeStats()
    cache = PartitionBlockCache(64 << 20, stats=stats)
    keys = np.stack([np.frombuffer(k, np.uint8)
                     for k in _sample_keys(index, 64, seed=1)])
    rows, found = index.lookup(keys)
    direct = index.fetch_rows(rows, found)
    for _ in range(2):
        cached = cache.fetch_rows(index, rows, found)
        assert [_rec_bytes(c) for c in cached] == [_rec_bytes(d) for d in direct]
    assert stats.cache_misses > 0 and stats.cache_hits > 0
    lo, hi = index.n // 5, 4 * index.n // 5
    assert (_rec_bytes(cache.materialize(index, lo, hi))
            == _rec_bytes(index.materialize(lo, hi)))
    # the JAX index over the same file + manifest returns the same bytes
    jindex = JIndex.open(index.path)
    jrows, jfound = jindex.lookup(keys)
    np.testing.assert_array_equal(rows, jrows)
    assert [_rec_bytes(r) for r in jindex.fetch_rows(jrows, jfound)] == [
        _rec_bytes(d) for d in direct
    ]
    jindex.close()


def test_router_routes_points_and_splits_ranges(sorted_case, tmp_path):
    index = sorted_case
    bounds = np.linspace(0, index.n, 4).astype(int)
    shards = []
    for s in range(3):
        raw, out = str(tmp_path / f"s{s}.raw"), str(tmp_path / f"s{s}.bin")
        with open(raw, "wb") as f:
            f.write(_rec_bytes(
                index.materialize(int(bounds[s]), int(bounds[s + 1]))
            ))
        text.sort_file(raw, out, tconfig.SortConfig(
            manifest=True, n_partitions=4, device="cpu",
            fmt=None if index.records is not None else "line",
        ))
        shards.append(SortedFileIndex.open(out, device="cpu"))
    router = ShardRouter([[s] for s in shards])
    assert router.n == index.n
    for key in _sample_keys(index, 50, seed=2):
        shard = router.pick(router.shard_for_key(index.pad_key(key)))
        _, found = shard.lookup(np.frombuffer(key, np.uint8)[None, :])
        assert bool(found[0])
    parts = router.split_range(index.min_key(), index.max_key())
    assert [sid for sid, _, _ in parts] == [0, 1, 2]
    got = b"".join(_rec_bytes(router.pick(sid).range_scan(lo, hi))
                   for sid, lo, hi in parts)
    assert got == _rec_bytes(index.materialize(0, index.n))
    with pytest.raises(ValueError, match="interleave"):
        ShardRouter([[index], [shards[0]]])
    for s in shards:
        s.close()


def test_latency_reservoir_equals_jax():
    xs = np.random.default_rng(11).lognormal(mean=-7.0, sigma=1.5, size=20_000)
    t, j = LatencyReservoir(), JReservoir()
    t.extend(xs)
    j.extend(xs)
    np.testing.assert_array_equal(t.counts, j.counts)
    for pct in (0, 50, 90, 99, 99.9, 100):
        assert t.percentile(pct) == j.percentile(pct)


def test_serve_config_and_cli():
    jfields = {f.name: f.default for f in dataclasses.fields(jconfig.ServeConfig)}
    tfields = {f.name: f.default for f in dataclasses.fields(tconfig.ServeConfig)}
    assert tfields.pop("device") == "cuda"
    assert tfields == jfields
    import argparse

    ap = argparse.ArgumentParser()
    tconfig.add_sort_cli_args(ap)
    tconfig.add_serve_cli_args(ap)  # one --device serves both
    args = ap.parse_args(["--device", "cpu", "--max-batch", "8"])
    assert tconfig.sort_config_from_args(args).device == "cpu"
    scfg = tconfig.serve_config_from_args(args)
    assert (scfg.device, scfg.max_batch) == ("cpu", 8)
    assert tconfig.serve_config_from_args(ap.parse_args([])).device == "cuda"


def test_query_launcher_on_cpu(tmp_path):
    stats = tquery.main([
        "--device", "cpu", "--records", "5000", "--skewed", "--points",
        "300", "--ranges", "5", "--workdir", str(tmp_path),
    ])
    assert stats.n_point == 300 and stats.n_range == 5
    assert stats.n_hits >= 150 and stats.qps > 0
