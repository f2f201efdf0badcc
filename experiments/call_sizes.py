#!/usr/bin/env python3
"""Call times by size in a run of a one-card cell.

The result line of ``perfbench/run.py`` gives the rate and the 95th
percentile over every call of the window, whatever its size.  This runs
the cell as ``perfbench/run.py`` does and, before the result line, logs
for each size of the mix its calls, how many took the stable fallback,
and the median and 95th percentile of their times:

    python3 experiments/call_sizes.py --workload gensort-skew.hbm-arrays \\
        --seed 1 --seconds 15 [--trace 1] [--tree DIR]

``--tree`` runs another checkout's program and benchmark (its ``src/``
and ``perfbench/``).  The ``call_sizes:`` lines go to standard error
with the harness's log; the last line of standard output is the
cell's result line.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--tree", default=os.path.dirname(HERE))
    args = ap.parse_args(argv)
    root = Path(args.tree).resolve()
    # the caches of perfbench/run.py, in the tree run
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(root / "src" / "repro_torch" / "_build")
    os.environ["TRITON_CACHE_DIR"] = str(root / "perfbench" / ".cache" / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(root / "perfbench" / ".cache" / "nv")
    sys.path[:0] = [str(root), str(root / "src")]

    import torch

    from perfbench import harness, manifest, stats

    cell = manifest.cell(manifest.load(root), args.workload, root)
    if cell.chips != 1 or not torch.cuda.is_available():
        harness.log(f"error: {args.workload} is not a one-card cell on a card here")
        return 2
    result_line = harness.result_line

    def logged(cell, ctx, *a, **kw):
        for n in sorted({c.n for c in ctx.calls}):
            ms = [c.seconds * 1e3 for c in ctx.calls if c.n == n]
            fell = sum(c.overflow for c in ctx.calls if c.n == n)
            harness.log(f"call_sizes: {n} records: {len(ms)} calls, {fell} fell back, "
                        f"ms p50 {stats.percentile(ms, 50):.4f} "
                        f"p95 {stats.percentile(ms, 95):.4f}")
        return result_line(cell, ctx, *a, **kw)

    harness.result_line = logged
    torch.cuda.set_device(0)
    result = manifest.runner(cell)(
        cell, args.seed, args.seconds, bool(args.trace), device="cuda", t_start=T_START,
    )
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
