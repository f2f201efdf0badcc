#!/usr/bin/env python3
"""Each rank's own device time in a traced run of a multi-card cell.

The traced result line of ``perfbench/run.py`` gives its breakdown as a
mean over the ranks, so the rank that sets the pace does not show.  This
runs the cell as ``perfbench/run.py --trace 1`` does and, before rank 0
prints its line, logs for each rank its device busy seconds, its top
ops, and the seconds and ms a call of each kernel named by ``--kernel``
(a bare function name, as ``perfbench.trace.kernel_id`` gives it):

    python3 experiments/mesh_rank_ops.py --workload gensort-skew-4gpu.mesh-arrays \\
        --seed 1 --seconds 15 [--tree DIR] [--kernel hist_kernel ...]

``--tree`` runs another checkout's program and benchmark (its ``src/``
and ``perfbench/``), with this script's logging laid over its ranks.
The ``rank_ops:`` lines go to standard error with the ranks' logs.
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
KERNELS_ENV = "RANK_OPS_KERNELS"
RANK_MAIN = "from perfbench import mesh_harness; mesh_harness.rank_main()"
TOP = 12


def rank_main() -> None:
    """A rank's process: ``mesh_harness.rank_main`` with rank 0 logging
    every rank's trace before its result line."""
    from perfbench import mesh_harness, trace

    kernels = json.loads(os.environ[KERNELS_ENV])
    result_line = mesh_harness.result_line

    def logged(cell, w, ranks, *args, **kwargs):
        calls = len(w.calls)
        for r, run in enumerate(ranks):
            tr = run.trace
            by: dict = {}
            for name, _, ns in tr.device:  # compacted: one entry an op
                by[name] = by.get(name, 0.0) + ns / 1e9
            mesh_harness.log(f"rank_ops: rank {r}: busy {tr.busy_s:.6f} s of "
                             f"{tr.window_s:.6f} s, {calls} calls")
            for name, s in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]:
                mesh_harness.log(f"rank_ops: rank {r}: {s:.6f} s, {s / calls * 1e3:.3f} "
                                 f"ms a call: {name[:140]}")
            for k in kernels:
                s = tr.kernel_seconds(k)
                mesh_harness.log(f"rank_ops: rank {r}: kernel {k} {s:.6f} s, "
                                 f"{s / calls * 1e3:.3f} ms a call")
        return result_line(cell, w, ranks, *args, **kwargs)

    mesh_harness.result_line = logged
    mesh_harness.rank_main()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--tree", default=os.path.dirname(HERE))
    ap.add_argument("--kernel", action="append", default=[])
    args = ap.parse_args(argv)
    root = Path(args.tree).resolve()
    # the caches of perfbench/run.py, in the tree run
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(root / "src" / "repro_torch" / "_build")
    os.environ["TRITON_CACHE_DIR"] = str(root / "perfbench" / ".cache" / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(root / "perfbench" / ".cache" / "nv")
    os.environ[KERNELS_ENV] = json.dumps(args.kernel)
    sys.path[:0] = [str(root), str(root / "src")]

    from perfbench import manifest, mesh_harness
    from repro_torch.launch import mesh

    cell = manifest.cell(manifest.load(root), args.workload, root)
    spawn = mesh.spawn

    def spawn_ranks(code, world_size, **kwargs):
        if RANK_MAIN not in code:
            raise RuntimeError("the tree's mesh_harness starts its ranks another way")
        code = code.replace(RANK_MAIN, f"sys.path.append({HERE!r}); "
                                       "import mesh_rank_ops; mesh_rank_ops.rank_main()")
        return spawn(code, world_size, **kwargs)

    mesh.spawn = spawn_ranks
    return mesh_harness.main(cell, args.seed, args.seconds, True, t_start=T_START)


if __name__ == "__main__":
    sys.exit(main())
