"""Pod-scale partition-and-concatenate sort over several ranks on the
PyTorch port: the paper's fragment-files-and-concatenation mapped onto
one all-to-all (DESIGN.md §2).  The counterpart of
``examples/distributed_sort_demo.py``, which re-execs itself with 8 XLA
host devices: here the script spawns ``--ranks`` processes through
``repro_torch.launch.mesh.spawn``, each one rank of a gloo process
group (on the card they share ``cuda:0``; ``--device cpu`` runs them on
the host).

    PYTHONPATH=src python examples/torch_distributed_sort_demo.py
    PYTHONPATH=src python examples/torch_distributed_sort_demo.py --tiny --device cpu

Every rank makes the same seeded skewed records, takes its shard and
trains the same CDF model on the same 1 % sample;
``distributed.make_sort_fn`` routes, exchanges and sorts, and rank 0
checks the global order against ``np.lexsort``.  The last line is one
JSON object with the result and each rank's sorter-kernel launches.
"""

import argparse
import json
import os
import sys
import tempfile

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
sys.path.insert(0, SRC)

import numpy as np


def rank_main() -> None:
    """One rank, spawned by :func:`main` (``RANK``, ``WORLD_SIZE`` and
    the ``DEMO_*`` variables set); prints one ``DEMO`` JSON line."""
    import torch

    from repro_torch.core import distributed, encoding, rmi
    from repro_torch.data import gensort
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as tmesh

    env = os.environ
    world, rank, n = int(env["WORLD_SIZE"]), int(env["RANK"]), int(env["DEMO_RECORDS"])
    dev = env["DEMO_DEVICE"]
    tmesh.initialize_multiprocess(f"file://{env['DEMO_STORE']}", world, rank,
                                  backend="gloo", device=dev, timeout_s=120)
    mesh = tmesh.make_data_mesh(device=dev)
    recs = gensort.make_records(n, skewed=True)
    hi, lo = encoding.encode_np(recs[:, :10])
    sample = recs[np.random.default_rng(0).choice(n, n // 100, replace=False), :10]
    model = rmi.fit(sample, n_leaf=4096)

    per = n // world
    s = slice(rank * per, (rank + 1) * per)
    args = [torch.from_numpy(w[s].astype(np.int64)).to(mesh.device) for w in (hi, lo)]
    args.append(torch.arange(n, dtype=torch.int32)[s].to(mesh.device))
    fn = distributed.make_sort_fn(mesh, ("data",), model, n_per_device=per)
    ops.reset_launches()
    out = fn(*args)
    launches = {f.__name__: f.launches for f in ops.KERNEL_WRAPPERS}
    full = [mesh.all_gather(t) for t in out]
    res = {"rank": rank, "device": str(mesh.device), "launches": launches}
    if rank == 0:
        gh, gl, gv = distributed.global_sorted_from_shards(*full[:4], world)
        o = np.lexsort((lo, hi))
        res.update(
            n_valid=full[3].reshape(-1).tolist(), lost=int(full[4].sum()),
            ok=bool(gh.shape[0] == n and (gh == hi[o]).all() and (gl == lo[o]).all()
                    and np.unique(gv).shape[0] == n))
    print("DEMO " + json.dumps(res), flush=True)
    tmesh.exit_rank()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--records", type=int, default=1 << 18)  # 262k records
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--tiny", action="store_true", help="16,384 records over 2 ranks")
    args = ap.parse_args()
    if args.tiny:
        args.records, args.ranks = 1 << 14, 2
    from repro_torch.core.executor import resolve_device
    from repro_torch.launch import mesh as tmesh

    resolve_device(args.device)  # no card for "cuda": fail before any work
    n, world = args.records - args.records % args.ranks, args.ranks
    print(f"[1/3] {world} ranks on {args.device}: {n} skewed records, "
          "the CDF model on a 1% sample ...")
    print("[2/3] make_sort_fn: route -> all_to_all -> LearnedSort ...")
    with tempfile.TemporaryDirectory(prefix="elsar_torch_demo_") as tmp:
        here = os.path.dirname(os.path.abspath(__file__))
        outs = tmesh.spawn(
            "import torch_distributed_sort_demo as d; d.rank_main()", world, timeout_s=600,
            env={"PYTHONPATH": os.pathsep.join([here, SRC, os.environ.get("PYTHONPATH", "")]),
                 "DEMO_RECORDS": str(n), "DEMO_DEVICE": args.device,
                 "DEMO_STORE": os.path.join(tmp, "store")})
    ranks = [json.loads(next(s[5:] for s in o.splitlines() if s.startswith("DEMO ")))
             for o in outs]
    res = ranks[0]
    print("[3/3] validating global order ...")
    assert res["lost"] == 0 and res["ok"], res
    nv = np.asarray(res["n_valid"])
    print(f"OK: {n} records globally sorted across {world} ranks; per-rank load "
          f"{nv.tolist()} (max/min {nv.max() / nv.min():.2f}) — equi-depth, no merge phase.")
    print(json.dumps({"records": n, "ranks": world, "ok": res["ok"], "lost": res["lost"],
                      "n_valid": res["n_valid"], "devices": [r["device"] for r in ranks],
                      "launches": [r["launches"] for r in ranks]}))


if __name__ == "__main__":
    main()
