"""ELSAR-Serve launcher of the port (port of ``src/repro/launch/serve.py``):
a long-lived query server over sorted output, predicting on the card.

    # serve one sorted file (needs its <file>.manifest.npz sidecar):
    PYTHONPATH=src python -m repro_torch.launch.serve --attach sorted.bin \
        --socket /tmp/elsar.sock

    # serve several disjoint shards, replicas comma-separated inside a
    # shard:
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --attach shard0.bin,shard0_replica.bin --attach shard1.bin \
        --host 127.0.0.1 --port 7071

    # no sorted file yet? generate + sort + serve in one go (add
    # --device cpu to run without a card):
    PYTHONPATH=src python -m repro_torch.launch.serve --records 200000 \
        --port 0

The wire protocol is newline-delimited JSON (keys and records travel
hex-encoded); see DESIGN.md §14:

    {"id": 1, "op": "point", "key": "<hex>"}
    {"id": 2, "op": "range", "lo": "<hex>", "hi": "<hex>"}
    {"id": 3, "op": "stats"}          {"id": 4, "op": "ping"}

Responses echo ``id``; shed requests answer ``{"ok": false, "error":
"overloaded"}`` immediately.  Range responses can be large — clients
should raise their line-read limit (asyncio's default is 64 KiB).

SIGTERM/SIGINT trigger a graceful drain: the listener closes, queued
queries still execute, every in-flight response is flushed, then the
process exits printing the final ``ServeStats`` summary.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import signal
import tempfile

from repro_torch.core import external
from repro_torch.core.config import (
    add_serve_cli_args,
    add_sort_cli_args,
    serve_config_from_args,
    sort_config_from_args,
)
from repro_torch.data import gensort
from repro_torch.serve.index import SortedFileIndex
from repro_torch.serve.router import ShardRouter
from repro_torch.serve.server import QueryServer


def _open_target(args):
    """Build the serving target: a router over --attach shard groups, or
    a single freshly sorted file."""
    if args.attach:
        groups = [
            [SortedFileIndex.open(p, device=args.device)
             for p in spec.split(",")]
            for spec in args.attach
        ]
        for g in groups:
            print(f"[serve] shard {g[0].path} x{len(g)} replicas "
                  f"({g[0].n} records, "
                  f"{g[0].manifest.n_partitions} partitions)")
        if len(groups) == 1 and len(groups[0]) == 1:
            return groups[0][0]
        return ShardRouter(groups)
    inp = args.input
    workdir = args.workdir or tempfile.mkdtemp(prefix="elsar_serve_")
    os.makedirs(workdir, exist_ok=True)
    if inp is None:
        inp = os.path.join(workdir, "input.bin")
        gensort.write_file(inp, args.records, skewed=args.skewed)
        print(f"[serve] generated {args.records} "
              f"{'skewed' if args.skewed else 'uniform'} records")
    out = args.output or os.path.join(workdir, "sorted.bin")
    stats = external.sort_file(
        inp, out, sort_config_from_args(args, manifest=True)
    )
    print(f"[serve] sorted {stats.n_records} records in "
          f"{stats.wall_seconds:.2f}s, manifest {stats.manifest_path}")
    return SortedFileIndex.open(out, device=args.device)


async def _run(args) -> None:
    server = QueryServer(_open_target(args), serve_config_from_args(args))
    await server.start()
    print(f"[serve] listening on {server.address} "
          f"(max_batch={server.config.max_batch}, "
          f"max_wait={server.config.max_wait_ms}ms, "
          f"queue_bound={server.config.queue_bound}, "
          f"cache={server.config.cache_bytes >> 20}MB)", flush=True)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    print("[serve] draining ...", flush=True)
    await server.stop(drain=True)
    print(f"[serve] {server.stats.summary()}")


def main(argv: "list[str] | None" = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--attach", action="append",
                    help="sorted file + manifest to serve; repeat per "
                         "shard, comma-separate replicas within a shard")
    ap.add_argument("--input", help="unsorted file to sort before serving")
    ap.add_argument("--records", type=int, default=100_000,
                    help="records to generate when no --attach/--input")
    ap.add_argument("--skewed", action="store_true")
    ap.add_argument("--output", help="sorted output path (default: workdir)")
    add_sort_cli_args(ap)
    add_serve_cli_args(ap)
    args = ap.parse_args(argv)
    asyncio.run(_run(args))


if __name__ == "__main__":
    main()
