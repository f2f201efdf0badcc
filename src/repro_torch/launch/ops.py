"""Operator launcher of the port (port of ``src/repro/launch/ops.py``):
merge-free external join / dedup / group-by (``core/operators.py``,
DESIGN.md §9).

Two entry modes per operator — **sort-then-operate** (raw inputs: train
one shared model, co-partition-sort every input, then stream the
operator) and **attach** (inputs are already-sorted runs with
``<file>.manifest.npz`` sidecars carrying the same model hash):

    # inner-join two newline corpora on a 12-byte key window
    PYTHONPATH=src python -m repro_torch.launch.ops join \\
        --left a.txt --right b.txt --output joined.txt \\
        --line --key-bytes 12 --budget-mb 8 --readers 3

    # attach to two co-partitioned sorted runs (skips the sorts)
    PYTHONPATH=src python -m repro_torch.launch.ops join \\
        --attach-left a.sorted --attach-right b.sorted --output j.txt

    # duplicate removal with occurrence counts
    PYTHONPATH=src python -m repro_torch.launch.ops dedup \\
        --input x.txt --output uniq.txt --line --counts

    # group-by sum over the ASCII value column at content bytes [12, 20)
    PYTHONPATH=src python -m repro_torch.launch.ops groupby \\
        --input x.txt --output sums.txt --line \\
        --agg sum --value-offset 12 --value-width 8

    # the same on the host, without a card
    PYTHONPATH=src python -m repro_torch.launch.ops dedup \\
        --input x.txt --output uniq.txt --line --device cpu

The sorts run on ``--device`` (the card by default; ``--sort-executor``
picks the executor), and so does ``--verify --use-kernels``: one RMI
kernel launch re-buckets both inputs' partition boundary keys.  The
operators themselves stream on the host.

Every operator output is itself a sorted run with a v3 manifest, so it
can be served (``python -m repro_torch.launch.query --attach <output>``)
or fed into further operators unchanged.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.core import operators
from repro_torch.core.config import add_sort_cli_args, sort_config_from_args
from repro_torch.core.format import LineFormat


def _add_common(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--output", required=True, help="operator output path")
    ap.add_argument("--line", action="store_true",
                    help="newline-delimited records (default: gensort fixed)")
    ap.add_argument("--key-bytes", type=int, default=12,
                    help="key window width for --line inputs")
    add_sort_cli_args(ap)
    ap.add_argument("--no-manifest", action="store_true",
                    help="skip the output manifest (output not servable)")


def _fmt(args):
    return LineFormat(max_key_bytes=args.key_bytes) if args.line else None


def _sorted_inputs(args, raw_paths: "list[str]") -> "list[str]":
    """Sort-then-operate front half: co-partition-sort the raw inputs
    under one shared model, printing per-sort rates."""
    workdir = args.workdir or tempfile.mkdtemp(prefix="elsar_ops_")
    os.makedirs(workdir, exist_ok=True)
    # index prefix: two inputs may share a basename (a/data.txt joined
    # with b/data.txt) and must not overwrite each other's sorted run
    outs = [
        os.path.join(workdir, f"{i}_{os.path.basename(p)}.sorted")
        for i, p in enumerate(raw_paths)
    ]
    _, stats = operators.sort_co_partitioned(
        raw_paths, outs,
        sort_config_from_args(
            args, fmt=_fmt(args), workdir=workdir, flush_bytes=1 << 20
        ),
    )
    for p, s in zip(raw_paths, stats):
        print(f"[ops] sorted {p} -> {s.n_records} records in "
              f"{s.wall_seconds:.2f}s ({s.rate_mb_s():.0f} MB/s, "
              f"{len(s.partition_counts)} partitions)")
    return outs


def _report(st: operators.OpStats) -> None:
    print(f"[ops] {st.op}: {st.n_left}"
          + (f" x {st.n_right}" if st.n_right else "")
          + f" -> {st.n_out} records ({st.output_bytes} bytes) over "
          f"{st.n_partitions} partitions in {st.wall_seconds:.2f}s "
          f"({st.rate_mb_s():.0f} MB/s in, "
          f"{st.spill_fallbacks} spill fallbacks)")
    if st.manifest_path:
        print(f"[ops] output manifest {st.manifest_path} — servable via "
              f"`python -m repro_torch.launch.query --attach <output>`")


def main(argv: "list[str] | None" = None) -> operators.OpStats:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.ops")
    sub = ap.add_subparsers(dest="op", required=True)

    j = sub.add_parser("join", help="merge-free external equi-join")
    j.add_argument("--left", help="raw left input (sort-then-operate)")
    j.add_argument("--right", help="raw right input (sort-then-operate)")
    j.add_argument("--attach-left", help="sorted left run with manifest")
    j.add_argument("--attach-right", help="sorted right run with manifest")
    j.add_argument("--how", choices=("inner", "left"), default="inner")
    j.add_argument("--verify", action="store_true",
                   help="re-bucket partition boundary keys (invariant check)")
    j.add_argument("--use-kernels", action="store_true",
                   help="run --verify through the dual-input RMI kernel "
                        "on --device")
    _add_common(j)

    d = sub.add_parser("dedup", help="merge-free duplicate removal")
    d.add_argument("--input", help="raw input (sort-then-operate)")
    d.add_argument("--attach", help="sorted run with manifest")
    d.add_argument("--counts", action="store_true",
                   help="annotate survivors with occurrence counts")
    _add_common(d)

    g = sub.add_parser("groupby", help="merge-free group-by aggregation")
    g.add_argument("--input", help="raw input (sort-then-operate)")
    g.add_argument("--attach", help="sorted run with manifest")
    g.add_argument("--agg", choices=("count", "sum"), default="count")
    g.add_argument("--value-offset", type=int, default=0,
                   help="content byte offset of the ASCII value column")
    g.add_argument("--value-width", type=int, default=0,
                   help="width of the ASCII value column (required for sum)")
    _add_common(g)

    args = ap.parse_args(argv)
    budget = args.budget_mb << 20

    if args.op == "join":
        if bool(args.left) != bool(args.right) or (
            bool(args.attach_left) != bool(args.attach_right)
        ):
            ap.error("join needs both --left/--right or both "
                     "--attach-left/--attach-right")
        if bool(args.left) == bool(args.attach_left):
            ap.error("join needs exactly one of --left/--right or "
                     "--attach-left/--attach-right")
        if args.left:
            left, right = _sorted_inputs(args, [args.left, args.right])
        else:
            left, right = args.attach_left, args.attach_right
        st = operators.external_join(
            left, right, args.output,
            how=args.how,
            memory_budget_bytes=budget,
            emit_manifest=not args.no_manifest,
            verify=args.verify,
            use_kernels=args.use_kernels,
            device=args.device,
        )
    else:
        if bool(args.input) == bool(args.attach):
            ap.error(f"{args.op} needs exactly one of --input or --attach")
        src = (
            _sorted_inputs(args, [args.input])[0]
            if args.input
            else args.attach
        )
        if args.op == "dedup":
            st = operators.external_dedup(
                src, args.output,
                counts=args.counts,
                memory_budget_bytes=budget,
                emit_manifest=not args.no_manifest,
            )
        else:
            st = operators.external_groupby(
                src, args.output,
                agg=args.agg,
                value_offset=args.value_offset,
                value_width=args.value_width,
                memory_budget_bytes=budget,
                emit_manifest=not args.no_manifest,
            )
    _report(st)
    return st


if __name__ == "__main__":
    main()
