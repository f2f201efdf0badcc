#!/usr/bin/env python3
"""Which collectives and DTensor steps run on gloo ranks that share one
CUDA card: the question behind ``chip_smoke.py`` phase 13's backend.

Four gloo ranks on ``cuda:0`` (spawned by ``launch.mesh.spawn``) each
print a line, flushed, before and after every step: each
``torch.distributed`` collective DTensor issues on CUDA tensors
(all-reduce, all-gather, reduce-scatter, all-to-all, broadcast), then a
2 x 2 ``DeviceMesh`` from ``init_device_mesh``, an all-gather on one of
its dims' groups, the functional all-gather DTensor uses (over the world
and on a mesh dim), then DTensor redistributions (Shard -> Replicate,
Partial -> Shard) on it.  A step
that raises is reported and the probe goes on; a step that kills the
process leaves its "before" line last in the rank's output, which
``spawn`` shows.  Then one NCCL rank runs qwen3-4b's smoke train step
on a (1, 1) DTensor mesh against the plain step.

    python3 experiments/gloo_cuda_probe.py
"""

import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RANK = r"""
import os, torch, torch.distributed as dist
from repro_torch.launch import mesh as M

def say(msg):
    print(f"rank {os.environ['RANK']}: {msg}", flush=True)

M.initialize_multiprocess("file://" + os.environ["STORE"], backend="gloo",
                          device="cuda", timeout_s=120)
say("process group up")
dev = torch.device("cuda", 0)
w = dist.get_world_size()
x = torch.arange(8, dtype=torch.float32, device=dev) + dist.get_rank()

def step(name, fn):
    say(f"before {name}")
    try:
        fn()
        say(f"after {name}: ok")
    except Exception as e:
        say(f"after {name}: {type(e).__name__}: {str(e)[:200]}")

step("all_reduce", lambda: dist.all_reduce(x.clone()))
step("all_gather_into_tensor",
     lambda: dist.all_gather_into_tensor(torch.empty(8 * w, device=dev), x))
step("reduce_scatter_tensor",
     lambda: dist.reduce_scatter_tensor(torch.empty(8 // w, device=dev), x))
step("all_to_all_single", lambda: dist.all_to_all_single(torch.empty_like(x), x))
step("broadcast", lambda: dist.broadcast(x.clone(), 0))
step("all_reduce bf16", lambda: dist.all_reduce(x.to(torch.bfloat16)))

mesh = None
def make():
    global mesh
    mesh = M.make_device_mesh((2, 2), ("data", "model"))
step("init_device_mesh (2, 2)", make)
if mesh is not None:
    import torch.distributed._functional_collectives as funcol
    step("all_gather_into_tensor on a mesh dim's group",
         lambda: dist.all_gather_into_tensor(torch.empty(16, device=dev), x,
                                             group=mesh.get_group(0)))
    step("functional all_gather_tensor over the world",
         lambda: funcol.all_gather_tensor(x, 0, dist.group.WORLD).wait())
    step("functional all_gather_tensor on a mesh dim",
         lambda: funcol.all_gather_tensor(x, 0, (mesh, 0)).wait())
    from torch.distributed.tensor import Partial, Replicate, Shard, distribute_tensor
    t = torch.arange(64, dtype=torch.float32, device=dev).reshape(8, 8)
    d = {}
    step("distribute_tensor", lambda: d.setdefault(
        "t", distribute_tensor(t, mesh, [Shard(0), Shard(1)], src_data_rank=None)))
    if "t" in d:
        step("Shard -> Replicate", lambda: d["t"].full_tensor())
        p = {}
        step("from_local Partial", lambda: p.setdefault("p", __import__(
            "torch.distributed.tensor", fromlist=["DTensor"]).DTensor.from_local(
                t, mesh, [Partial(), Replicate()], run_check=False)))
        if "p" in p:
            step("Partial -> Shard", lambda: p["p"].redistribute(
                mesh, [Shard(0), Replicate()]).to_local())
say("done")
M.exit_rank()
"""

NCCL = r"""
import copy, os, torch
from repro_torch.configs import registry
from repro_torch.launch import mesh as M
from repro_torch.models.api import build_model
from repro_torch.sharding import rules, spmd
from repro_torch.train import optimizer as opt_lib, train_loop
M.initialize_multiprocess("file://" + os.environ["STORE"], backend="nccl", device="cuda")
mesh = M.make_device_mesh((1, 1), ("data", "model"))
cfg = registry.get_config("qwen3-4b", smoke=True)
model = build_model(cfg)
plain = model.trainable(model.init_params(seed=0))
sharded = copy.deepcopy(plain)
rules.set_active_mesh(mesh)
spmd.distribute_params(sharded, mesh)
tok = torch.randint(0, cfg.vocab_raw, (4, 32), device="cuda", dtype=torch.int32)
losses = []
for params in (plain, sharded):
    step = train_loop.build_train_step(model, opt_lib.AdamWConfig(lr=3e-3, warmup_steps=1))
    state = opt_lib.init_state(params)
    losses.append([float(step(params, state, {"tokens": tok})[2]["loss_total"])
                   for _ in range(3)])
print(f"nccl (1, 1): plain {losses[0]} sharded {losses[1]}", flush=True)
M.exit_rank()
"""


def main() -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    from repro_torch.launch import mesh as tmesh

    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 2
    env = {"PYTHONPATH": os.path.join(ROOT, "src")}
    with tempfile.TemporaryDirectory() as tmp:
        try:
            outs = tmesh.spawn(RANK, 4, timeout_s=300,
                               env={**env, "STORE": os.path.join(tmp, "s1")})
            for out in outs:
                print(out, end="")
        except RuntimeError as e:
            print(f"gloo ranks failed: {e}")
        try:
            out = tmesh.spawn(NCCL, 1, timeout_s=300,
                              env={**env, "STORE": os.path.join(tmp, "s2")})
            print(out[0], end="")
        except RuntimeError as e:
            print(f"nccl rank failed: {e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
