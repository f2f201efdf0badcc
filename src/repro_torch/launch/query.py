"""Query launcher of the port (port of ``src/repro/launch/query.py``):
sort-then-serve, or attach to an existing manifest.

    # generate, sort on the card (emitting the sidecar manifest), then
    # serve a synthetic point/range workload through the RMI kernel:
    PYTHONPATH=src python -m repro_torch.launch.query --records 200000 \
        --skewed --readers 2 --points 2000 --ranges 50 --batch 64

    # sort an existing record file:
    PYTHONPATH=src python -m repro_torch.launch.query --input in.bin

    # attach to an already-sorted file + <file>.manifest.npz:
    PYTHONPATH=src python -m repro_torch.launch.query --attach sorted.bin

    # the same on the host, without a card:
    PYTHONPATH=src python -m repro_torch.launch.query --device cpu

Point queries are drawn from the file (hits) mixed with uniform random
keys (misses); range queries span ``--range-records`` consecutive
records' worth of key space.  Prints per-phase seconds and the latency /
throughput summary (``QueryStats``); :func:`main` also returns it.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from repro_torch.core import external
from repro_torch.core.config import add_sort_cli_args, sort_config_from_args
from repro_torch.data import gensort
from repro_torch.serve.index import SortedFileIndex
from repro_torch.serve.query_engine import QueryEngine, QueryStats


def make_workload(
    index: SortedFileIndex,
    n_points: int,
    n_ranges: int,
    range_records: int,
    seed: int = 0,
) -> tuple[np.ndarray, "list[tuple[bytes, bytes]]"]:
    """Synthetic serving workload: ~50/50 hit/miss point keys + ranges
    spanning ``range_records`` consecutive records.  Shared by this CLI
    and ``chip_smoke.py``.  Format-generic: keys come from the index's
    padded key window, so line-format runs serve the same way."""
    rng = np.random.default_rng(seed)
    n = index.n
    kw = index.key_width
    if n_points:
        hit = rng.choice(n, size=max(n_points // 2, 1), replace=True)
        miss = np.random.default_rng(seed + 1).integers(
            gensort.ASCII_LO, gensort.ASCII_HI + 1,
            size=(n_points - hit.shape[0], kw), dtype=np.uint8,
        )
        points = np.concatenate(
            [index.keys_at(np.sort(hit)), miss]
        )[:n_points]
        rng.shuffle(points, axis=0)
    else:
        points = np.empty((0, kw), dtype=np.uint8)
    ranges = []
    for _ in range(n_ranges):
        a = int(rng.integers(0, max(n - range_records, 1)))
        b = min(n - 1, a + range_records)
        lo_hi = index.keys_at(np.array([a, b]))
        ranges.append((lo_hi[0].tobytes(), lo_hi[1].tobytes()))
    return points, ranges


def main(argv: "list[str] | None" = None) -> QueryStats:
    ap = argparse.ArgumentParser()
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--input", help="unsorted record file to sort + serve")
    src.add_argument("--attach", help="sorted file with an existing manifest")
    ap.add_argument("--records", type=int, default=100_000,
                    help="records to generate when no --input/--attach")
    ap.add_argument("--skewed", action="store_true")
    ap.add_argument("--output", help="sorted output path (default: tempdir)")
    add_sort_cli_args(ap)
    ap.add_argument("--points", type=int, default=2000)
    ap.add_argument("--ranges", type=int, default=50)
    ap.add_argument("--range-records", type=int, default=1000,
                    help="records per range scan")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--use-kernels", action="store_true",
                    help="on the CPU, predict through the RMI kernel's "
                         "plain version (a card always runs the kernel)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.attach:
        index = SortedFileIndex.open(args.attach, device=args.device)
        print(f"[query] attached {args.attach} ({index.n} records, "
              f"{index.manifest.n_partitions} partitions, "
              f"err band -{index.manifest.err_lo}/+{index.manifest.err_hi})")
    else:
        inp = args.input
        workdir = args.workdir
        if inp is None:
            workdir = workdir or tempfile.mkdtemp(prefix="elsar_query_")
            os.makedirs(workdir, exist_ok=True)
            inp = os.path.join(workdir, "input.bin")
            gensort.write_file(inp, args.records, skewed=args.skewed)
            print(f"[query] generated {args.records} "
                  f"{'skewed' if args.skewed else 'uniform'} records")
        out = args.output or os.path.join(
            workdir or tempfile.mkdtemp(prefix="elsar_query_"), "sorted.bin"
        )
        stats = external.sort_file(
            inp, out, sort_config_from_args(args, manifest=True)
        )
        print(f"[query] sorted {stats.n_records} records in "
              f"{stats.wall_seconds:.2f}s ({stats.rate_mb_s():.0f} MB/s), "
              f"manifest {stats.manifest_path}")
        index = SortedFileIndex.open(out, device=args.device)

    points, ranges = make_workload(
        index, args.points, args.ranges, args.range_records, args.seed
    )
    with QueryEngine(
        index, n_workers=args.workers, use_kernels=args.use_kernels
    ) as engine:
        for i in range(0, points.shape[0], args.batch):
            engine.point(points[i : i + args.batch])
        if ranges:
            engine.range(ranges)
    for phase, sec in sorted(engine.stats.phase_seconds.items()):
        print(f"[query]   {phase:8s} {sec:.3f}s")
    print(f"[query] {engine.stats.summary()}")
    index.close()
    return engine.stats


if __name__ == "__main__":
    main()
