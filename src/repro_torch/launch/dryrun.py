"""Pod-scale dry run (port of ``src/repro/launch/dryrun.py``): for every
(arch x shape x mesh) cell, build the real train step, prefill or decode
step over the production mesh and trace it once on ``meta`` tensors —
nothing is allocated, no card is needed — and record the per-device
FLOPs, bytes, collectives and memory.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --out experiments/dryrun_torch --jobs 4

The reference lowers and compiles each cell for 256 (or 512) fake XLA
host devices in one process.  Here one process is rank 0 of a ``"fake"``
process group of world size 256 (``single``: 16 x 16 over ``("data",
"model")``) or 512 (``multi``: 2 x 16 x 16 over ``("pod", "data",
"model")``): collectives return at once, and every tensor lives on the
``meta`` device (shapes and dtypes only; ``FakeTensorMode`` cannot take
the shard-offset reads of DTensor's strided layouts).  The parameters, the optimizer state, the
batch and the decode cache are DTensors laid out by ``sharding.rules``,
and the step runs as it runs on real ranks (``sharding/spmd.py``), so
the counts are rank 0's.  ``launch.cost_analysis`` counts FLOPs, bytes
and collectives below DTensor's dispatch; memory is the local bytes of
the arguments and outputs, the outputs updated in place counted as
aliased (the reference donates the parameters, optimizer state and
cache), and the temp memory is the peak of the live tensors the step
made (``cost_analysis``'s ``peak_bytes``).  ``lower_s``/``compile_s``
become ``trace_s``.  A cell that cannot be
traced is written with ``"status": "error"``; reruns skip cells already
written.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import registry
from repro_torch.configs.base import shape_applicable
from repro_torch.launch import cost_analysis
from repro_torch.launch.mesh import init_fake_process_group, make_production_mesh
from repro_torch.models.api import build_model
from repro_torch.sharding import rules, spmd
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_loop


def _microbatches(arch: str, shape_name: str) -> int:
    # keep the per-layer remat stash (B_loc x S x D x 2B) x L small a rank
    return 8 if shape_name == "train_4k" else 1


def _fake_pg(world: int) -> None:
    """A fake process group of ``world`` ranks (replacing another size)."""
    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    init_fake_process_group(world)


def _tree(x):
    """A module as its parameters, a decode cache as its layers."""
    if isinstance(x, torch.nn.Module):
        return dict(x.named_parameters())
    return x.layers if hasattr(x, "layers") else x


def _leaves(tree) -> list:
    return [t for t in torch.utils._pytree.tree_leaves(_tree(tree))
            if isinstance(t, torch.Tensor)]


def _local_bytes(*trees) -> int:
    total = 0
    for tree in trees:
        for t in _leaves(tree):
            t = t.to_local() if spmd.is_dtensor(t) else t
            total += t.numel() * t.element_size()
    return total


def run_cell(arch: str, shape_name: str, mesh_kind: str, donate: bool = True,
             *, smoke: bool = False, mesh=None, shape=None) -> dict:
    """One cell's record.  ``smoke`` traces the arch's smoke config;
    ``mesh`` (a ``DeviceMesh`` over an initialised fake process group)
    replaces the production mesh of ``mesh_kind``, and ``shape`` (a
    ``ShapeConfig``) the registry's shape of ``shape_name``."""
    cfg = registry.get_config(arch, smoke=smoke)
    shape = shape or registry.get_shape(shape_name)
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "reason": why}
    if mesh is None:
        _fake_pg(512 if mesh_kind == "multi" else 256)
        mesh = make_production_mesh(multi_pod=mesh_kind == "multi", device="cpu")
    n_chips = mesh.size()
    rules.set_active_mesh(mesh)
    model = build_model(cfg)
    t0 = time.time()
    try:
        params = model.empty_params("meta")
        spmd.distribute_params(params, mesh)
        batch = spmd.shard_batch(model.input_specs(shape), mesh)
        if shape.kind == "train":
            model.trainable(params)
            opt_state = opt_lib.init_state(params)
            fn = train_loop.build_train_step(
                model, opt_lib.AdamWConfig(),
                microbatches=_microbatches(arch, shape_name))
            args, donated = (params, opt_state, batch), (params, opt_state)
        elif shape.kind == "prefill":
            fn = torch.no_grad()(model.prefill)
            args, donated = (params, batch), ()
        else:
            cache = model.cache_spec(shape)
            spmd.shard_cache(cache, mesh, seq_sharded=shape.global_batch == 1)
            fn = torch.no_grad()(model.decode_step)
            args, donated = (params, cache, batch["tokens"]), (cache,)

        arg_bytes = _local_bytes(*args)
        mode = cost_analysis.CostMode()
        with mode, spmd.sharded_context():
            out = fn(*args)
        outs = out if isinstance(out, tuple) else (out,)
        if shape.kind == "train":  # params and state are updated in place
            outs = (params, opt_state, outs[2])
        out_bytes = _local_bytes(*outs)
        alias = _local_bytes(*donated) if donate else 0
    finally:
        rules.set_active_mesh(None)
    cost = mode.cost
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_kind,
        "status": "ok",
        "n_chips": n_chips,
        "trace_s": round(time.time() - t0, 1),
        # per-device roofline inputs (rank 0's local shards)
        "flops_per_device": cost.dot_flops,
        "bytes_accessed_per_device": cost.hbm_bytes,
        "collectives": cost.as_dict()["collectives"],
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": cost.peak_bytes,
            "alias_bytes": alias,
        },
    }


def _cells(args) -> list[tuple[str, str]]:
    if args.all:
        return [(a, s) for a in registry.ARCHS for s in registry.SHAPES]
    return [(args.arch, args.shape)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a process of its own")
    args = ap.parse_args()
    torch.set_num_threads(1)  # meta tensors: the trace is host-bound Python

    os.makedirs(args.out, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    todo = []
    for arch, shape in _cells(args):
        for mesh_kind in meshes:
            tag = f"{arch}__{shape}__{mesh_kind}"
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path):
                print(f"[skip existing] {tag}")
                continue
            todo.append((arch, shape, mesh_kind, tag, path))

    if args.jobs > 1:
        sys.exit(_run_jobs(todo, args))
    failures = 0
    for arch, shape, mesh_kind, tag, path in todo:
        print(f"[dryrun] {tag} ...", flush=True)
        try:
            res = run_cell(arch, shape, mesh_kind)
        except Exception as e:
            traceback.print_exc()
            res = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                   "status": "error", "error": f"{type(e).__name__}: {e}"[:2000]}
            failures += 1
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
        print(f"  -> {res['status']}"
              + (f" trace={res['trace_s']}s flops/dev={res['flops_per_device']:.3g}"
                 if res["status"] == "ok" else ""), flush=True)
    sys.exit(1 if failures else 0)


def _run_jobs(todo, args) -> int:
    """Each cell in a process of its own, ``args.jobs`` at a time."""
    pending, running, failures = list(todo), [], 0
    while pending or running:
        while pending and len(running) < args.jobs:
            arch, shape, mesh_kind, tag, path = pending.pop(0)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                   "--shape", shape, "--mesh", mesh_kind, "--out", args.out]
            log = open(os.path.join(args.out, tag + ".log"), "w")
            running.append((subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                            log, tag))
        time.sleep(1.0)
        for item in list(running):
            proc, log, tag = item
            if proc.poll() is None:
                continue
            running.remove(item)
            log.close()
            failures += proc.returncode != 0
            print(f"[dryrun] {tag} -> rc {proc.returncode}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    main()
