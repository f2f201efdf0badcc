"""Run sets of runs of cells, one process a run, one after another, and
report each metric's median and spread (the bounds' yardstick).

    python3 perfbench/sets.py --cells <cell>[,<cell>...] --seeds 11,12,13 \
        [--seconds S] [--trace 0|1] [--sets 2] [--out DIR]

Each run is ``perfbench/run.py``, started as a benchmark run starts
it.  Its result line, exit code and the end of its standard error go
to ``DIR/<cell>.jsonl`` (default ``perfbench/.cache/sets``); a summary
follows on standard output: for each cell, set and metric the values,
the median and the spread (quartile distance over the median,
``statistics.quantiles(values, n=4)``).  With ``--sets 2`` the same seeds
run twice, as two sets.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one_run(cell: str, seed: int, seconds: float, traced: int) -> dict:
    cmd = [sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload", cell,
           "--seed", str(seed), "--seconds", str(seconds), "--trace", str(traced)]
    t = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    lines = p.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        result = None
    return {"cell": cell, "seed": seed, "trace": traced, "rc": p.returncode,
            "wall_s": time.perf_counter() - t, "result": result,
            "stderr_tail": p.stderr[-6000:]}


def summary(runs: list) -> list[str]:
    out = []
    by: dict = {}
    for r in runs:
        res = r["result"] or {}
        for name, m in res.get("metrics", {}).items():
            by.setdefault((r["cell"], r.get("set", 0), name), []).append(m["value"])
    for (cell, s, name), vals in sorted(by.items()):
        line = f"{cell} set {s} {name}: n={len(vals)} median {statistics.median(vals):.6g}"
        if len(vals) >= 2:
            q1, q2, q3 = statistics.quantiles(vals, n=4)
            line += f" spread {(q3 - q1) / q2:.6f}"
        out.append(line + f" values {[round(v, 6) for v in vals]}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--out", default=str(ROOT / "perfbench" / ".cache" / "sets"))
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    seconds = args.seconds or bench["run_seconds"]
    seeds = [int(s) for s in args.seeds.split(",")]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    runs = []
    for cell in args.cells.split(","):
        for s in range(args.sets):
            for seed in seeds:
                r = one_run(cell, seed, seconds, args.trace)
                r["set"] = s
                runs.append(r)
                with open(out / f"{cell}.jsonl", "a") as f:
                    f.write(json.dumps(r) + "\n")
                res = r["result"] or {}
                print(f"run {cell} set {s} seed {seed} trace {args.trace} rc {r['rc']} "
                      f"wall {r['wall_s']:.1f} s correct {res.get('correct')} "
                      f"attempted {res.get('attempted')} metrics "
                      f"{ {k: v['value'] for k, v in res.get('metrics', {}).items()} }",
                      flush=True)
                if r["rc"] != 0 or not res.get("correct"):
                    print(r["stderr_tail"][-3000:], flush=True)
    print("\n".join(summary(runs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
