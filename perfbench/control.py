"""Run the controls and the planted faults of a cell at its own size.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \
        [--seconds S] [--paths hi32,f64,unchanged,half,altered,unstable,rows,fallback,program]

For each seed and each path, one run of the cell (``harness.run_cell``)
with that path in the program's place, in this one process (the set-up
is paid per run, as in the benchmark).  Prints one JSON line a run:
the seed, the path, ``correct`` and the numbers compared.  ``program`` is
the program's own path, for the lower readings.  The benchmark's own
runs never run this.

A cell on several cards (``chips`` over 1) runs every seed and path in
one set of rank processes (``mesh_harness.control``): the model and the
sorts are set up once, a pool is made for each seed, and each path has
a window of ``--seconds`` and the distributed check; its paths are
``controls.MESH_CONTROLS``, ``controls.MESH_FAULTS`` and ``program``.

A cell whose mix names a driver runs each seed and path through that
driver's ``run``, with its ``sort_for(path)`` in the program's place;
its paths default to the driver's ``PATHS``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the one-card harness's controls and faults (``controls.py``)
PATHS = ("hi32", "f64", "unchanged", "half", "altered", "unstable", "rows", "fallback")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--paths", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import controls, harness, manifest

    cell = manifest.cell(manifest.load(ROOT), args.workload, ROOT)
    seeds = [int(s) for s in args.seeds.split(",")]
    drv = cell.traffic.get("driver")
    if drv is not None:  # the driver's own controls and faults
        drv = manifest.driver(drv)
        run, sort_for, paths = drv.run, drv.sort_for, drv.PATHS
    else:
        run, paths = harness.run_cell, PATHS

        def sort_for(name):
            return controls.sort_for(name, harness.program_sort())
    paths = args.paths.split(",") if args.paths else list(paths)
    if cell.chips > 1:
        from perfbench import mesh_harness

        if args.device == "cuda":
            from repro_torch.kernels import build

            build.library()
        for line in mesh_harness.control(cell, seeds, paths, args.seconds,
                                         device=args.device):
            print(json.dumps(line), flush=True)
        return 0
    for seed in seeds:
        for name in paths:
            sort = None if name == "program" else sort_for(name)
            r = run(cell, seed, args.seconds, False, device=args.device,
                    t_start=time.perf_counter(), sort=sort)
            print(json.dumps({"workload": args.workload, "seed": seed, "path": name,
                              "correct": r["correct"], "attempted": r["attempted"],
                              "failed": r["failed"], "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
