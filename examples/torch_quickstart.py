"""Quickstart on the PyTorch port: generate a gensort-style file,
ELSAR-sort it with the Sort stage on the card, validate.

    PYTHONPATH=src python examples/torch_quickstart.py [n_records] [n_readers]
    PYTHONPATH=src python examples/torch_quickstart.py 20000 2 --device cpu

The counterpart of ``examples/quickstart.py``.  ``--device`` is where the
Sort stage runs: ``cuda`` (the default; it raises when no card is
present) or ``cpu``.  With ``n_readers > 1`` the pipelined runtime
partitions with an r-way striped reader pool and overlaps the
partition/sort/write phases (paper §3.2); the output is byte-identical
either way, and to the host executor's.  ``--workdir`` keeps the input
and the sorted file there.  The last line is one JSON object: the
record count, the validation, the output's sha256 and the launches of
each sorter kernel (0 on the CPU, where the kernels' plain versions
run).
"""

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.core import external, validate
from repro_torch.core.config import SortConfig
from repro_torch.core.executor import resolve_device
from repro_torch.data import gensort
from repro_torch.kernels import ops


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_records", nargs="?", type=int, default=500_000)  # 50 MB
    ap.add_argument("n_readers", nargs="?", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args()
    resolve_device(args.device)  # no card for "cuda": fail before any work
    n, n_readers = args.n_records, args.n_readers
    tmp = args.workdir or tempfile.mkdtemp(prefix="elsar_torch_quickstart_")
    os.makedirs(tmp, exist_ok=True)
    inp = os.path.join(tmp, "input.bin")
    out = os.path.join(tmp, "sorted.bin")

    print(f"[1/3] generating {n} records ({n * 100 / 1e6:.0f} MB), skewed ...")
    gensort.write_file(inp, n, skewed=True, seed=args.seed)
    chk = validate.checksum(gensort.read_records(inp, mmap=False))

    print(
        f"[2/3] ELSAR sort on {args.device} (learned CDF partition-and-concatenate, "
        f"{n_readers} reader{'s' if n_readers > 1 else ''}) ..."
    )
    ops.reset_launches()
    t0 = time.time()
    stats = external.sort_file(inp, out, config=SortConfig(
        memory_budget_bytes=64 << 20, n_readers=n_readers, device=args.device))
    dt = time.time() - t0
    launches = {f.__name__: f.launches for f in ops.KERNEL_WRAPPERS}

    print("[3/3] valsort-style validation ...")
    res = validate.validate_file(out, chk, n)
    assert res["ok"], res

    counts = np.array(stats.partition_counts)
    print(
        f"\nsorted {n} records in {dt:.1f}s ({stats.rate_mb_s():.0f} MB/s), "
        f"executor {stats.executor}\n"
        f"partitions: {len(counts)} (equi-depth std/mean "
        f"{counts.std() / counts.mean():.3f})\n"
        f"phases: "
        + ", ".join(f"{k}={v:.2f}s" for k, v in stats.phase_seconds.items())
        + (
            f"\npipeline: wall {stats.wall_seconds:.2f}s vs "
            f"{stats.total_seconds:.2f}s busy -> "
            f"{stats.overlap_seconds:.2f}s overlapped"
        )
        + f"\nkernel launches: {launches}"
        + f"\nvalidation: {res}"
    )
    print(json.dumps({"records": n, "ok": bool(res["ok"]), "sha256": sha256(out),
                      "input": inp, "output": out, "executor": stats.executor,
                      "seconds": dt, "launches": launches}))


if __name__ == "__main__":
    main()
