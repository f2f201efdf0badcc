#!/usr/bin/env python3
"""Drive the PyTorch port's main path and its serving path on one CUDA
card and check them.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero):

1. build   — compile the encode, RMI, bitonic and histogram kernels from
   ``src/repro_torch/csrc`` (nvcc, sm_90a) and load them;
2. kernels — each kernel against its plain PyTorch version on the card,
   bit for bit, at the shapes the paths give it: encode at
   (1,441,792, 8); RMI at 2**20 buckets with 25,000 and 65,536 leaves on
   uniform and skewed keys, each in generation order and in the main
   path's routed order (two range partitions, each shuffled), and at the
   serving shape (10,000,000 buckets, batches of 64 and 4096 keys);
   bitonic at (8192, 1024) — the batch the
   256 MB default budget produces on a 1 GB file (15 partitions of
   ~667k records, two per batch, padded to 1,441,792 slots) — and over a
   sweep of every width ``fused.plan_batch`` gives, at ~8.4M slots each
   (``BITONIC_SWEEP``), on random, all-equal, SENTINEL-row, presorted
   and reversed rows, each width timed against ``torch.sort``; histogram
   at 1,441,792 ids over 8192, 58,113, the split strategy's top bin
   count (116,224), 464,896 and 2**20 bins, on routed, uniform,
   out-of-range and all-equal ids, with its strategy;
   and the launch floor (a 1-element PyTorch add, timed the same way)
   beside RMI's serving shape and the histogram;
3. main    — ``repro_torch.core.external.sort_file`` under
   ``SortConfig(manifest=True)`` (device ``cuda``) on a 1 GB skewed
   gensort file (10M records), validated, with every kernel of the sort
   launched, and its manifest loaded back;
4. serve   — ``QueryServer`` under the default ``ServeConfig()`` over
   that file: 10,000 point queries (half hits) and 200 range scans of
   1,000 records, every answer held against a NumPy ``searchsorted``
   oracle, the RMI kernel launched while serving; then 4,096 of the
   points and the ranges through ``QueryEngine`` for its phase seconds, and
   ``repro_torch.launch.query`` end to end at 200,000 records;
5. bytes   — a 1M-record uniform file sorted on the card has the same
   sha256 as the port's host-executor output.

It then prints one JSON line describing each kernel (times from CUDA
events, bounds from the bytes each call must move at 3.35 TB/s or its
operations at 67 TFLOP/s), the card's name and power limit, and as the
last line ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the repository beside it, it exits non-zero and prints no
result.
"""

import asyncio
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
NON_TENSOR_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
MAIN_RECORDS = 10_000_000
BATCH = 1_441_792  # pad_target of two ~667k-record partitions
IDENTITY_RECORDS = 1_000_000
# the grid's rows per batch; one bin past a block's shared memory (the
# split strategy); 8 blocks' shared memory (global); fused.Q_RES (the
# split strategy's top bin count, read from the device, is added)
HIST_BINS = (8192, 58_113, 464_896, 1 << 20)
HALF = 666_896  # records of the batch's first partition
# 10,000 points, not 20,000: each hit costs 24-38 ms of host time (this
# script, beside an H100 80GB HBM3 at 700 W), because a 1 GB file's
# ~67 MB partitions exceed the default 64 MB block cache, whose bypass
# copies the whole partition per fetch
SERVE_POINTS, SERVE_RANGES, RANGE_RECORDS = 10_000, 200, 1_000
ENGINE_POINTS = 4096
QUERY_RECORDS = 200_000
# row widths fused.plan_batch gives: 512-1024 below 4.2M slots, 2048-4096
# above, 8-256 for small batches of many segments; and the widest row
BITONIC_SWEEP = ((16384, 512), (8192, 1024), (4096, 2048), (2048, 4096),
                 (1_048_576, 8), (2, 16384))


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, reps: int = 20, cold: bool = True) -> float:
    """Median milliseconds of one ``fn()`` on the card, by CUDA events.

    Before each timed launch the card spins for ~1 ms (``_sleep``), so
    the host has enqueued the launch before the start event fires and
    the interval holds device time only.  ``cold``: a 256 MB write
    first evicts the 50 MB L2, so every input comes from device memory
    (the bound's assumption); otherwise inputs stay warm in L2."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if cold:
            flush.zero_()
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def raw_launch(torch, entry, *args):
    """A C entry point called with preallocated tensors and no wrapper
    work, so that a short kernel's time is not the host's; the return
    code is checked once, outside the timed loops."""
    from repro_torch.kernels import build

    lib = build.library()
    fn = getattr(lib, entry)
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch.cuda.current_stream().cuda_stream
    build.check(fn(*ptrs, stream), entry)
    return lambda: fn(*ptrs, stream)


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / NON_TENSOR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(torch, got, want) -> int:
    return max(
        int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) if g.numel() else 0
        for g, w in zip(got, want)
    )


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(what)


def phase_kernels(torch, dev) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    import numpy as np

    from repro_torch.core import encoding, rmi as rmi_lib
    from repro_torch.data import gensort
    from repro_torch.kernels import bitonic, encode, fused, rmi

    results: dict = {}
    n = BATCH
    keys_np = {
        "uniform": gensort.uniform_keys(n, seed=1),
        "skewed": gensort.skewed_keys(n, seed=1, start_idx=n),
    }

    # -- encode ------------------------------------------------------------
    keys8 = torch.from_numpy(keys_np["skewed"][:, :8].copy()).to(dev)
    got, want = encode.encode_cuda(keys8), encode.encode_plain(keys8)
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    require(err == 0, f"encode kernel differs from its plain version by {err}")
    b_ms, b_by = bound(n * (8 + 16), 0)
    launch = raw_launch(torch, "repro_encode", keys8, got[0], got[1], n)
    results["encode"] = dict(
        name="encode", route="cuda", source=encode.SOURCE,
        replaces="src/repro/kernels/encode.py:29",
        max_abs_err=err,
        ms=cuda_ms(torch, launch),
        plain_ms=cuda_ms(torch, lambda: encode.encode_plain(keys8)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )
    log(f"kernels: encode ({n}, 8) bit-equal; kernel "
        f"{results['encode']['ms']:.4f} ms (warm L2 "
        f"{cuda_ms(torch, launch, cold=False):.4f} ms), plain "
        f"{results['encode']['plain_ms']:.4f} ms, bound {b_ms:.4f} ms")

    # keys as the main path routes them: two range partitions, each in an
    # order of its own
    order = np.concatenate([
        np.random.default_rng(2).permutation(HALF),
        HALF + np.random.default_rng(3).permutation(n - HALF),
    ])
    routed = {}
    for dist, k in keys_np.items():
        kv = np.ascontiguousarray(k).view("S10").reshape(-1)
        routed[dist] = k[np.argsort(kv, kind="stable")][order]

    # -- RMI ---------------------------------------------------------------
    rmi_err, rmi_entry, model_main = 0, None, None
    for n_leaf in (25_000, 65_536):
        for dist in ("uniform", "skewed"):
            # the main path trains n_leaf = sample / 4 leaves
            sample = keys_np[dist][:: max(1, n // (4 * n_leaf))]
            model = rmi_lib.fit(sample, n_leaf=n_leaf).to(dev)
            for key_order, k in (("generation", keys_np[dist]),
                                 ("routed", routed[dist])):
                hi, lo = encode.encode_cuda(
                    torch.from_numpy(k[:, :8].copy()).to(dev)
                )
                got = rmi.rmi_bucket_cuda(model, hi, lo, fused.Q_RES)
                want = rmi.rmi_bucket_plain(model, hi, lo, fused.Q_RES)
                torch.cuda.synchronize()
                err = max_abs_err(torch, [got], [want])
                require(err == 0, f"RMI kernel (L={n_leaf}, {dist}, "
                                  f"{key_order} order) differs by {err}")
                rmi_err = max(rmi_err, err)
                launch = raw_launch(
                    torch, "repro_rmi_bucket", hi, lo, n,
                    int(model.min_hi), int(model.min_lo),
                    float(model.inv_range), float(model.root_slope),
                    float(model.root_intercept), fused.Q_RES,
                    model.kernel_table, n_leaf, got,
                )
                ms = cuda_ms(torch, launch)
                warm = cuda_ms(torch, launch, cold=False)
                plain = cuda_ms(
                    torch,
                    lambda: rmi.rmi_bucket_plain(model, hi, lo, fused.Q_RES),
                    reps=5,
                )
                # kept at n x 20 B + L x 36 B (the split tables' bytes) so
                # that bounds compare across designs; the packed rows are
                # 32 B a leaf
                table_bytes = n_leaf * (5 * 4 + 2 * 8)
                b_ms, b_by = bound(n * (8 + 8 + 4) + table_bytes, 0)
                log(f"kernels: rmi n={n} L={n_leaf} {dist} {key_order} order "
                    f"bit-equal; kernel {ms:.4f} ms (warm L2 {warm:.4f} ms), "
                    f"plain {plain:.4f} ms, bound {b_ms:.4f} ms = "
                    f"{b_ms / ms:.1%} of bound")
                if (n_leaf, dist, key_order) == (25_000, "skewed", "routed"):
                    # the 1 GB main path trains 25,000 leaves on skewed
                    # keys and routes them so
                    model_main = model
                    rmi_entry = dict(
                        name="rmi_bucket", route="cuda", source=rmi.SOURCE,
                        replaces="src/repro/kernels/rmi.py:64",
                        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                        library_ms=None,
                    )
    rmi_entry["max_abs_err"] = rmi_err
    results["rmi_bucket"] = rmi_entry

    # -- bitonic: the rows the grid graph builds for a main-path batch ------
    keys_b = torch.from_numpy(routed["skewed"][:, :8].copy()).to(dev)
    seg = torch.from_numpy(
        (np.arange(n) >= HALF).astype(np.int32)
    ).to(dev)
    n_rows, capacity = fused.plan_batch(n, 15)
    require((n_rows, capacity) == (8192, 1024), f"plan {n_rows}x{capacity}")
    alloc = np.ones(2, np.int64) + (n_rows - 2) * np.array([HALF, n - HALF]) // n
    plan = np.zeros(2 * 15, np.int32)
    plan[15:17] = alloc
    plan[1] = alloc[0]
    plan_d = torch.from_numpy(plan).to(dev)
    _, _, hi_m, lo_m, val_m, counts = fused.grid_rows(
        model_main, keys_b, seg, plan_d[:15], plan_d[15:],
        n_rows=n_rows, capacity=capacity,
    )
    require(int(counts.sum()) == n, "grid rows lost records")
    got = bitonic.sort_rows_cuda(hi_m, lo_m, val_m)
    want = bitonic.sort_rows_plain(hi_m, lo_m, val_m)
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    require(err == 0, f"bitonic kernel differs from its plain version by {err}")
    packed = encoding.packed_key(hi_m, lo_m)
    slots = n_rows * capacity
    stages = capacity.bit_length() - 1
    stages = stages * (stages + 1) // 2
    b_ms, b_by = bound(slots * (8 + 8 + 4) * 2, slots // 2 * stages)
    results["sort_rows"] = dict(
        name="sort_rows", route="cuda", source=bitonic.SOURCE,
        replaces="src/repro/kernels/bitonic.py:86",
        max_abs_err=err,
        ms=cuda_ms(torch, raw_launch(
            torch, "repro_sort_rows", hi_m, lo_m, val_m, *got,
            n_rows, capacity, *bitonic.launch_geometry(capacity),
        )),
        plain_ms=cuda_ms(
            torch, lambda: bitonic.sort_rows_plain(hi_m, lo_m, val_m), reps=5
        ),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(
            torch, lambda: torch.sort(packed, dim=1, stable=True), reps=10
        ),
    )
    r = results["sort_rows"]
    log(f"kernels: sort_rows ({n_rows}, {capacity}) bit-equal "
        f"(max row fill {int(counts.max())}); kernel {r['ms']:.4f} ms, plain "
        f"{r['plain_ms']:.4f} ms, torch.sort {r['library_ms']:.4f} ms, "
        f"bound {b_ms:.4f} ms; {bitonic.launch_geometry(capacity)}, stages "
        f"{bitonic.stage_split(capacity)}")
    bitonic_sweep(torch, dev)

    # -- the launch floor: the least an event-timed launch can show -------
    one = torch.zeros(1, device=dev)
    floor = cuda_ms(torch, lambda: one.add_(1))
    log(f"kernels: launch floor (1-element add_, cold) {floor:.4f} ms")

    # -- RMI at the serving shape: rows of the 10M-record sorted file ------
    for b in (64, 4096):
        hi, lo = encode.encode_cuda(
            torch.from_numpy(keys_np["skewed"][:b, :8].copy()).to(dev)
        )
        got = rmi.rmi_bucket_cuda(model_main, hi, lo, MAIN_RECORDS)
        want = rmi.rmi_bucket_plain(model_main, hi, lo, MAIN_RECORDS)
        torch.cuda.synchronize()
        err = max_abs_err(torch, [got], [want])
        require(err == 0, f"RMI kernel (serving, {b} keys) differs by {err}")
        launch = raw_launch(
            torch, "repro_rmi_bucket", hi, lo, b,
            int(model_main.min_hi), int(model_main.min_lo),
            float(model_main.inv_range), float(model_main.root_slope),
            float(model_main.root_intercept), MAIN_RECORDS,
            model_main.kernel_table, model_main.n_leaf, got,
        )
        # a batch touches at most one 36-byte leaf row a key
        b_ms, _ = bound(b * (8 + 8 + 4) + min(b, model_main.n_leaf) * 36, 0)
        log(f"kernels: rmi serving shape ({b} keys, {MAIN_RECORDS} buckets) "
            f"bit-equal; kernel {cuda_ms(torch, launch):.4f} ms (warm L2 "
            f"{cuda_ms(torch, launch, cold=False):.4f} ms), plain "
            f"{cuda_ms(torch, lambda: rmi.rmi_bucket_plain(model_main, hi, lo, MAIN_RECORDS), reps=5):.4f} ms, "
            f"bound {b_ms:.6f} ms, launch floor {floor:.4f} ms")

    # -- histogram: the routing histogram of a main-path batch -------------
    from repro_torch.kernels import histogram

    hi, lo = encode.encode_cuda(
        torch.from_numpy(keys_np["skewed"][:, :8].copy()).to(dev)
    )
    max_bins = histogram.max_block_bins()
    top = histogram.SPLIT_CLUSTER * max_bins  # the split strategy's top
    log(f"kernels: histogram strategies: shared up to {max_bins} bins (a "
        f"block's shared memory), split over clusters of "
        f"{histogram.SPLIT_CLUSTER} up to {top}, global beyond")
    rng = np.random.default_rng(4)
    hist_err = 0
    for n_bins in sorted({*HIST_BINS, top}):
        uniform = rng.integers(0, n_bins, size=n, dtype=np.int32)
        mixed = uniform.copy()
        bad = rng.choice(n, size=n // 5, replace=False)
        mixed[bad] = rng.choice(
            np.array([-1, -9, n_bins, 2**31 - 1], np.int32), size=bad.size
        )
        cases = {
            # the ids the batch's keys route to at n_bins buckets
            "routed": rmi.rmi_bucket_cuda(model_main, hi, lo, n_bins),
            "uniform": torch.from_numpy(uniform).to(dev),
            "out_of_range": torch.from_numpy(mixed).to(dev),
            "equal": torch.full((n,), n_bins // 3, dtype=torch.int32,
                                device=dev),
        }
        geo = histogram.launch_geometry(n_bins, max_bins)
        for name, ids in cases.items():
            got = histogram.histogram_cuda(ids, n_bins)
            want = histogram.histogram_plain(ids, n_bins)
            keep = (ids >= 0) & (ids < n_bins)
            lib = torch.bincount(ids[keep], minlength=n_bins)
            torch.cuda.synchronize()
            err = max_abs_err(torch, [got], [want])
            require(err == 0, f"histogram kernel ({n_bins} bins, {name}) "
                              f"differs from its plain version by {err}")
            require(torch.equal(lib.to(torch.int32), got),
                    f"torch.bincount disagrees with the kernel ({n_bins} "
                    f"bins, {name})")
            require(int(got.sum()) == int(keep.sum()),
                    f"histogram ({n_bins}, {name}) counted out-of-range ids")
            hist_err = max(hist_err, err)
            out = torch.empty(n_bins, dtype=torch.int32, device=dev)
            ms = cuda_ms(torch, raw_launch(
                torch, "repro_histogram", ids, n, n_bins,
                histogram.STRATEGIES.index(geo.strategy), geo.cluster,
                geo.block_bins, geo.slice, out,
            ))
            b_ms, b_by = bound(n * 4 + n_bins * 4, n)
            line = (f"kernels: histogram ({n}, {n_bins}) {name} bit-equal "
                    f"({geo.strategy}, cluster {geo.cluster}, "
                    f"{geo.block_bins} bins a block); kernel {ms:.4f} ms, "
                    f"bound {b_ms:.4f} ms, launch floor {floor:.4f} ms")
            if name == "routed":
                entry = dict(
                    name="bucket_histogram", route="cuda",
                    source=histogram.SOURCE,
                    replaces="src/repro/kernels/histogram.py:33",
                    ms=ms,
                    plain_ms=cuda_ms(
                        torch,
                        lambda: histogram.histogram_plain(ids, n_bins),
                        reps=10,
                    ),
                    bound_ms=b_ms, bound_by=b_by,
                    library_ms=cuda_ms(
                        torch,
                        lambda: torch.bincount(ids, minlength=n_bins),
                        reps=10,
                    ),
                )
                line += (f", plain {entry['plain_ms']:.4f} ms, torch.bincount"
                         f" {entry['library_ms']:.4f} ms")
                if n_bins == HIST_BINS[0]:
                    results["histogram"] = entry
            log(line)
    results["histogram"]["max_abs_err"] = hist_err
    return results


def bitonic_sweep(torch, dev) -> None:
    """The row sorter at every width the main path can produce, ~8.4M
    slots each: bit-equal to its plain version on five kinds of rows,
    and timed cold beside its bound and ``torch.sort``."""
    from repro_torch.core import encoding
    from repro_torch.kernels import bitonic

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    for r, c in BITONIC_SWEEP:
        def words(high):
            return torch.randint(0, high, (r, c), device=dev, generator=gen)

        hi, lo = words(1 << 32), words(1 << 32)
        hi[:, ::3] %= 64  # some equal hi words, so lo and val break ties
        val = torch.randint(-(2**31), 2**31 - 1, (r, c), device=dev,
                            generator=gen, dtype=torch.int32)
        sorted_rows = bitonic.sort_rows_plain(hi, lo, val)
        sentinel = [t.clone() for t in (hi, lo, val)]
        sentinel[0][::2] = encoding.SENTINEL
        sentinel[1][::2] = encoding.SENTINEL
        sentinel[2][::2] = 2**31 - 1
        kinds = {
            "random": (hi, lo, val),
            "equal": (torch.full_like(hi, 7), torch.full_like(lo, 11), val),
            "sentinel_rows": tuple(sentinel),
            "presorted": sorted_rows,
            "reversed": tuple(t.flip(1).contiguous() for t in sorted_rows),
        }
        for kind, rows in kinds.items():
            got = bitonic.sort_rows_cuda(*rows)
            want = bitonic.sort_rows_plain(*rows)
            torch.cuda.synchronize()
            err = max_abs_err(torch, got, want)
            require(err == 0, f"bitonic kernel at ({r}, {c}) on {kind} rows "
                              f"differs from its plain version by {err}")
        geo = bitonic.launch_geometry(c)
        ms = cuda_ms(torch, raw_launch(
            torch, "repro_sort_rows", hi, lo, val, *got, r, c, *geo,
        ))
        packed = encoding.packed_key(hi, lo)
        lib_ms = cuda_ms(
            torch, lambda: torch.sort(packed, dim=1, stable=True), reps=10
        )
        stages = (c.bit_length() - 1) * c.bit_length() // 2
        b_ms, b_by = bound(r * c * (8 + 8 + 4) * 2, r * c // 2 * stages)
        log(f"kernels: sort_rows sweep ({r}, {c}) bit-equal on "
            f"{'/'.join(kinds)}; kernel {ms:.4f} ms, torch.sort "
            f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) = "
            f"{b_ms / ms:.1%} of bound; {geo.rows_per_block} rows x "
            f"{geo.threads_per_row} threads x {geo.elems} slots a block, "
            f"stages {bitonic.stage_split(c)}")


def phase_serve(torch, path: str, tmp: str) -> None:
    """Serve the sorted 1 GB file on the card and hold every answer
    against a NumPy oracle over the file's keys."""
    import numpy as np

    from repro_torch.core.config import ServeConfig
    from repro_torch.data import gensort
    from repro_torch.kernels import ops
    from repro_torch.launch import query
    from repro_torch.serve.index import SortedFileIndex
    from repro_torch.serve.query_engine import QueryEngine
    from repro_torch.serve.server import QueryServer

    cfg = ServeConfig()
    index = SortedFileIndex.open(path, device=cfg.device)
    require(index.device.type == "cuda", f"index on {index.device}")
    m = index.manifest
    points, ranges = query.make_workload(
        index, SERVE_POINTS, SERVE_RANGES, RANGE_RECORDS, seed=0
    )
    recs = gensort.read_records(path)
    keys = np.ascontiguousarray(recs[:, : index.key_width]).view("S10")
    keys = keys.reshape(-1)
    q = np.ascontiguousarray(points).view("S10").reshape(-1)
    rows = np.searchsorted(keys, q, side="left")
    found = (rows < index.n) & (keys[np.minimum(rows, index.n - 1)] == q)

    async def drive():
        server = await QueryServer(index, cfg, own_indexes=False).start()
        t0 = time.perf_counter()
        answers, scans = [], []
        # waves of queue_bound requests: admission never sheds
        for i in range(0, len(q), cfg.queue_bound):
            answers += await asyncio.gather(*[
                server.point(k.tobytes()) for k in points[i : i + cfg.queue_bound]
            ])
        for i in range(0, len(ranges), cfg.queue_bound):
            scans += await asyncio.gather(*[
                server.range_scan(lo, hi)
                for lo, hi in ranges[i : i + cfg.queue_bound]
            ])
        wall = time.perf_counter() - t0
        await server.stop()
        return answers, scans, wall, server.stats

    prof = start_device_trace(torch)
    ops.reset_launches()
    answers, scans, wall, sstats = asyncio.run(drive())
    torch.cuda.synchronize()
    launches = {f.__name__: f.launches for f in ops.KERNEL_WRAPPERS}
    if prof is not None:
        prof.__exit__(None, None, None)
    wrong = [
        i for i, r in enumerate(answers)
        if not r["ok"] or r["found"] != bool(found[i])
        or r["record"] != (recs[rows[i]].tobytes() if found[i] else None)
    ]
    require(not wrong, f"{len(wrong)} point answers differ from the oracle "
                       f"(first {answers[wrong[0]] if wrong else None})")
    spans = [
        (int(np.searchsorted(keys, np.bytes_(lo), side="left")),
         int(np.searchsorted(keys, np.bytes_(hi), side="right")))
        for lo, hi in ranges
    ]
    bad = [
        i for i, (r, (a, b)) in enumerate(zip(scans, spans))
        if not r["ok"] or r["count"] != b - a or r["data"] != recs[a:b].tobytes()
    ]
    require(not bad, f"{len(bad)} range answers differ from the oracle")
    require(launches["rmi_bucket"] > 0, "serving never launched the RMI kernel")
    require(index.observed_err_lo <= m.err_lo
            and index.observed_err_hi <= m.err_hi,
            f"observed error -{index.observed_err_lo}/+"
            f"{index.observed_err_hi} outside the band -{m.err_lo}/+{m.err_hi}")
    n_q = len(answers) + len(scans)
    log(f"serve: QueryServer {len(answers)} points ({int(found.sum())} hits) "
        f"+ {len(scans)} ranges of {RANGE_RECORDS} records, all ok and equal "
        f"to the oracle; {n_q / wall:.1f} q/s over {wall:.3f} s, p50 "
        f"{sstats.latency_ms(50):.3f} ms p99 {sstats.latency_ms(99):.3f} ms, "
        f"{sstats.n_batches} batches (occupancy {sstats.batch_occupancy:.4f}), "
        f"band hits {index.band_hits}, fallbacks {index.fallbacks}, error "
        f"band -{m.err_lo}/+{m.err_hi} (observed -{index.observed_err_lo}/+"
        f"{index.observed_err_hi}), launches {launches}")
    if prof is None:
        log("serve: device busy share not measured")
    else:
        busy, _ = device_time(prof)
        log(f"serve: device busy {busy * 1e3:.3f} ms of {wall:.3f} s wall = "
            f"{busy / wall:.6%} (torch.profiler)")

    # the first ENGINE_POINTS of the workload through the engine, for its
    # predict/search/scan seconds
    with QueryEngine(index) as eng:
        for i in range(0, min(ENGINE_POINTS, len(q)), cfg.max_batch):
            _, r, f = eng.point(points[i : i + cfg.max_batch])
            require((r == rows[i : i + cfg.max_batch]).all()
                    and (f == found[i : i + cfg.max_batch]).all(),
                    "QueryEngine point answers differ from the oracle")
        eng.range(ranges)
    est = eng.stats
    phases = {k: round(v, 4) for k, v in sorted(est.phase_seconds.items())}
    log(f"serve: QueryEngine batches of {cfg.max_batch}: {est.summary()}; "
        f"phase seconds {json.dumps(phases)}")
    index.close()

    # the launcher end to end: sort on the card, then serve
    ops.reset_launches()
    qstats = query.main([
        "--records", str(QUERY_RECORDS), "--skewed", "--points", "2000",
        "--ranges", "20", "--workdir", os.path.join(tmp, "query"),
    ])
    require(qstats.n_point == 2000 and qstats.n_hits >= 1000,
            f"launch.query served {qstats.summary()}")
    require(ops.rmi_bucket.launches > 0 and ops.encode_keys.launches > 0,
            "launch.query did not run the kernels")
    log(f"serve: launch.query {QUERY_RECORDS} records: {qstats.summary()}")


def checksum_file(validate, gensort, path: str) -> int:
    """validate.checksum over the whole file, summed chunk by chunk (the
    checksum is a sum of per-record hashes mod 2**64)."""
    recs = gensort.read_records(path)
    total = 0
    for i in range(0, recs.shape[0], 1 << 20):
        total += validate.checksum(recs[i : i + (1 << 20)])
    return total % (1 << 64)


def start_device_trace(torch):
    """A running ``torch.profiler`` trace of the card's activity, or None
    where the profiler cannot trace it (then the device time of the main
    path is reported as not measured)."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    try:
        prof.__enter__()
    except RuntimeError as e:
        log(f"main: profiler unavailable ({e})")
        return None
    return prof


def device_time(prof) -> tuple[float, list]:
    """Seconds of device activity in the trace, and the top entries."""
    rows = [
        (getattr(e, "self_device_time_total", 0.0) / 1e6, e.key, e.count)
        for e in prof.key_averages()
    ]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    return sum(r[0] for r in rows), rows[:8]


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.core import external, manifest, validate
        from repro_torch.core.config import SortConfig
        from repro_torch.data import gensort
        from repro_torch.kernels import build, ops
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 3

    # 1. build
    build.library()
    info = build.build_info
    log(f"build: {'compiled' if info['compiled'] else 'loaded the cached'} "
        f"{info['path']} in {info['seconds']:.1f} s")
    for src, lines in info["ptxas"].items():
        for line in lines:
            log(f"build:   {src}: {line}")

    # 2. kernels
    results = phase_kernels(torch, torch.device("cuda"))

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # 3. main path
        inp = os.path.join(tmp, "skewed.bin")
        out = os.path.join(tmp, "skewed.sorted")
        t0 = time.perf_counter()
        gensort.write_file(inp, MAIN_RECORDS, skewed=True, seed=0)
        refsum = checksum_file(validate, gensort, inp)
        log(f"main: wrote {MAIN_RECORDS} skewed records in "
            f"{time.perf_counter() - t0:.1f} s")
        prof = start_device_trace(torch)
        ops.reset_launches()
        stats = external.sort_file(inp, out, config=SortConfig(manifest=True))
        torch.cuda.synchronize()
        launches = {f.__name__: f.launches for f in ops.KERNEL_WRAPPERS}
        if prof is not None:
            prof.__exit__(None, None, None)
        res = validate.validate_file(out, refsum, MAIN_RECORDS)
        require(res["ok"], f"1 GB sort failed validation: {res}")
        require(stats.executor == "batched", f"executor {stats.executor}")
        for name in ("encode_keys", "rmi_bucket", "sort_rows"):
            require(launches[name] > 0,
                    f"{name} was never launched on the main path")
        m = manifest.load(stats.manifest_path)
        require(m.n_records == MAIN_RECORDS
                and int(m.part_counts.sum()) == MAIN_RECORDS
                and m.model_hash == manifest.model_hash(m.model),
                "the 1 GB sort's manifest does not load back")
        phases = {k: round(v, 3) for k, v in stats.phase_seconds.items()}
        walls = {k: round(v, 3) for k, v in stats.phase_wall_seconds.items()}
        log(f"main: sort_file 1 GB ok in {stats.wall_seconds:.2f} s = "
            f"{stats.rate_mb_s():.1f} MB/s; planner {stats.planner_decision}, "
            f"{len(stats.partition_counts)} partitions, "
            f"device_dispatches {stats.device_dispatches}, "
            f"batch_occupancy {stats.batch_occupancy:.4f}, "
            f"fallbacks {stats.fallbacks}, shapes {stats.jit_compiles}, "
            f"launches {launches}")
        log(f"main: manifest {stats.manifest_path} loaded back: "
            f"{m.n_partitions} partitions, error band -{m.err_lo}/+{m.err_hi}")
        log(f"main: phase busy seconds {json.dumps(phases)}")
        log(f"main: phase wall seconds {json.dumps(walls)}")
        if prof is None:
            log("main: device busy share not measured")
        else:
            busy, top = device_time(prof)
            log(f"main: device busy {busy:.4f} s of {stats.wall_seconds:.2f} s "
                f"wall = {busy / stats.wall_seconds:.4%} (torch.profiler)")
            for sec, name, count in top:
                log(f"main:   {sec * 1e3:9.3f} ms  x{count:<4d} {name[:90]}")
        for key, name in (("encode", "encode_keys"), ("rmi_bucket", "rmi_bucket"),
                          ("sort_rows", "sort_rows"),
                          ("histogram", "bucket_histogram")):
            results[key]["launches"] = launches[name]
        os.unlink(inp)

        # 4. serve the sorted file
        phase_serve(torch, out, tmp)
        os.unlink(out)

        # 5. byte identity: the card's grid path == the host executor
        inp = os.path.join(tmp, "uniform.bin")
        gensort.write_file(inp, IDENTITY_RECORDS, seed=7)
        refsum = checksum_file(validate, gensort, inp)
        shas = {}
        for name, cfg in (
            ("cuda", SortConfig()),
            ("host", SortConfig(executor="host")),
        ):
            o = os.path.join(tmp, f"{name}.sorted")
            st = external.sort_file(inp, o, config=cfg)
            require(validate.validate_file(o, refsum, IDENTITY_RECORDS)["ok"],
                    f"{name} output failed validation")
            shas[name] = (sha256(o), st.executor)
        require(shas["cuda"][0] == shas["host"][0], f"outputs differ: {shas}")
        require(shas["cuda"][1] == "batched", f"card run used {shas['cuda'][1]}")
        log(f"bytes: 1M uniform records, card == host, sha256 {shas['cuda'][0]}")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{k: results[n][k] for k in keys}
               for n in ("encode", "rmi_bucket", "sort_rows", "histogram")]
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
