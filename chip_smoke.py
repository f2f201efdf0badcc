#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero):

1. build   — compile the encode, RMI and bitonic kernels from
   ``src/repro_torch/csrc`` (nvcc, sm_90a) and load them;
2. kernels — each kernel against its plain PyTorch version on the card,
   bit for bit, at the shapes the main path gives it: encode at
   (1,441,792, 8); RMI at 2**20 buckets with 25,000 and 65,536 leaves on
   uniform and skewed keys; bitonic at (8192, 1024) — the batch the
   256 MB default budget produces on a 1 GB file (15 partitions of
   ~667k records, two per batch, padded to 1,441,792 slots);
3. main    — ``repro_torch.core.external.sort_file`` under the default
   ``SortConfig()`` (device ``cuda``) on a 1 GB skewed gensort file
   (10M records), validated, with every kernel's launch count > 0;
4. bytes   — a 1M-record uniform file sorted on the card has the same
   sha256 as the port's host-executor output.

It then prints one JSON line describing each kernel (times from CUDA
events, bounds from the bytes each call must move at 3.35 TB/s or its
operations at 67 TFLOP/s), the card's name and power limit, and as the
last line ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the repository beside it, it exits non-zero and prints no
result.
"""

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

    # -- RMI ---------------------------------------------------------------
    rmi_err, rmi_entry, model_main = 0, None, None
    for n_leaf in (25_000, 65_536):
        for dist in ("uniform", "skewed"):
            k = keys_np[dist]
            # the main path trains n_leaf = sample / 4 leaves
            sample = k[:: max(1, n // (4 * n_leaf))]
            model = rmi_lib.fit(sample, n_leaf=n_leaf).to(dev)
            hi, lo = encode.encode_cuda(
                torch.from_numpy(k[:, :8].copy()).to(dev)
            )
            got = rmi.rmi_bucket_cuda(model, hi, lo, fused.Q_RES)
            want = rmi.rmi_bucket_plain(model, hi, lo, fused.Q_RES)
            torch.cuda.synchronize()
            err = max_abs_err(torch, [got], [want])
            require(err == 0, f"RMI kernel (L={n_leaf}, {dist}) differs by {err}")
            rmi_err = max(rmi_err, err)
            ft, ut = model.kernel_tables
            launch = raw_launch(
                torch, "repro_rmi_bucket", hi, lo, n,
                int(model.min_hi), int(model.min_lo),
                float(model.inv_range), float(model.root_slope),
                float(model.root_intercept), fused.Q_RES, ft, ut, n_leaf, got,
            )
            ms = cuda_ms(torch, launch)
            warm = cuda_ms(torch, launch, cold=False)
            plain = cuda_ms(
                torch,
                lambda: rmi.rmi_bucket_plain(model, hi, lo, fused.Q_RES),
                reps=5,
            )
            table_bytes = n_leaf * (5 * 4 + 2 * 8)
            b_ms, b_by = bound(n * (8 + 8 + 4) + table_bytes, 0)
            log(f"kernels: rmi n={n} L={n_leaf} {dist} bit-equal; kernel "
                f"{ms:.4f} ms (warm L2 {warm:.4f} ms), plain {plain:.4f} ms, "
                f"bound {b_ms:.4f} ms")
            if n_leaf == 25_000 and dist == "skewed":
                # the 1 GB main path trains 25,000 leaves on skewed keys
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
    k = keys_np["skewed"]
    kv = np.ascontiguousarray(k).view("S10").reshape(-1)
    k = k[np.argsort(kv, kind="stable")]  # two range partitions, as routed
    half = 666_896
    order = np.concatenate([
        np.random.default_rng(2).permutation(half),
        half + np.random.default_rng(3).permutation(n - half),
    ])
    keys_b = torch.from_numpy(k[order, :8].copy()).to(dev)
    seg = torch.from_numpy(
        (np.arange(n) >= half).astype(np.int32)
    ).to(dev)
    n_rows, capacity = fused.plan_batch(n, 15)
    require((n_rows, capacity) == (8192, 1024), f"plan {n_rows}x{capacity}")
    alloc = np.ones(2, np.int64) + (n_rows - 2) * np.array([half, n - half]) // n
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
            n_rows, capacity,
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
        f"bound {b_ms:.4f} ms")
    return results


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
        from repro_torch.core import external, validate
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
    for line in build.build_info["ptxas"]:
        log(f"build:   {line}")

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
        stats = external.sort_file(inp, out, config=SortConfig())
        torch.cuda.synchronize()
        launches = {f.__name__: f.launches for f in ops.KERNEL_WRAPPERS}
        if prof is not None:
            prof.__exit__(None, None, None)
        res = validate.validate_file(out, refsum, MAIN_RECORDS)
        require(res["ok"], f"1 GB sort failed validation: {res}")
        require(stats.executor == "batched", f"executor {stats.executor}")
        for name, count in launches.items():
            require(count > 0, f"{name} was never launched on the main path")
        phases = {k: round(v, 3) for k, v in stats.phase_seconds.items()}
        walls = {k: round(v, 3) for k, v in stats.phase_wall_seconds.items()}
        log(f"main: sort_file 1 GB ok in {stats.wall_seconds:.2f} s = "
            f"{stats.rate_mb_s():.1f} MB/s; planner {stats.planner_decision}, "
            f"{len(stats.partition_counts)} partitions, "
            f"device_dispatches {stats.device_dispatches}, "
            f"batch_occupancy {stats.batch_occupancy:.4f}, "
            f"fallbacks {stats.fallbacks}, shapes {stats.jit_compiles}, "
            f"launches {launches}")
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
        for name in ("encode_keys", "rmi_bucket", "sort_rows"):
            key = {"encode_keys": "encode"}.get(name, name)
            results[key]["launches"] = launches[name]
        os.unlink(inp)
        os.unlink(out)

        # 4. byte identity: the card's grid path == the host executor
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
               for n in ("encode", "rmi_bucket", "sort_rows")]
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
