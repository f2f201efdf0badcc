"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the CUDA cards the cell
asks for; without them it exits non-zero and prints no result.  The
last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its
limit); the last lines of standard error are the same checks.

A cell on several cards runs one process a rank (``mesh_harness``); this
process builds the kernel library, starts them, relays their logs and
prints rank 0's line.  A one-card cell runs in this process, through
the driver its mix names (``perfbench/drivers/<name>.py``) or, without
one, ``harness.run_cell``.

The program's kernel library is built into, and loaded from,
``src/repro_torch/_build/`` in the checkout; any other cache, and a
driver's data files, go under ``perfbench/.cache/``.  Nothing is
written elsewhere.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _cache_dirs() -> None:
    """Fixed cache directories inside the checkout, set before any CUDA
    or kernel-build code reads them."""
    cache = ROOT / "perfbench" / ".cache"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "src" / "repro_torch" / "_build")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from perfbench import harness, manifest

    cell = manifest.cell(manifest.load(ROOT), args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        harness.log(
            f"error: {args.workload} needs {cell.chips} CUDA card(s); "
            f"torch.cuda.is_available()={torch.cuda.is_available()}, "
            f"device_count={torch.cuda.device_count()}"
        )
        return 2
    if cell.chips > 1:  # one process a rank, each on its own card
        from perfbench import mesh_harness

        return mesh_harness.main(cell, args.seed, args.seconds, bool(args.trace),
                                 t_start=T_START)
    torch.cuda.set_device(0)
    import repro_torch  # noqa: F401  (the program under test: fail before any work)

    result = manifest.runner(cell)(
        cell, args.seed, args.seconds, bool(args.trace),
        device="cuda", t_start=T_START,
    )
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"error: loaded after the window: {bad}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
