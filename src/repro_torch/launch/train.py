"""Training launcher of the port (port of ``src/repro/launch/train.py``):
the end-to-end driver of the LM train step.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
        --smoke --steps 8 --device cpu

It trains on the card unless ``--device cpu`` is given (without a card
it raises).  Features, as in the reference: a deterministic, resumable
data pipeline (``SyntheticLM.batch_at(step)``), periodic atomic
checkpoints of the parameters (``ckpt_dir``) and the optimizer state
(``ckpt_dir + "_opt"``), resume from the latest committed step (elastic:
a checkpoint saved on the card restores on the host and the other way
round), a straggler watchdog and a retry policy around the step.

Batches carry tokens only, as the reference's: the vit projector then
gets no gradient, and an encoder-decoder arch (whisper), whose loss
needs ``frontend_embeds``, does not train from this launcher (train it
through ``train_loop.build_train_step`` with frames in the batch).

``mesh_shape`` names ``("data", "model")`` for two axes and
``("data",)`` for one, as the reference's does.  Its product must be the
world size: each rank calls :func:`train` after
``launch.mesh.initialize_multiprocess``, the parameters and the optimizer
state become DTensors laid out by ``sharding.rules`` over that mesh, and
each rank trains on its shard of every batch (``train_loop``).  Without
a process group the product must be 1 and the step is the plain
single-device one.  A checkpoint restores onto whatever mesh the run now
has.
"""

from __future__ import annotations

import argparse
import math
import time

import torch

import torch.distributed as dist

from repro_torch.configs import registry
from repro_torch.core.executor import resolve_device
from repro_torch.data.pipeline import PipelineConfig, SyntheticLM
from repro_torch.launch.mesh import make_device_mesh, rank_device
from repro_torch.models.api import build_model
from repro_torch.sharding import rules, spmd
from repro_torch.train import checkpoint, fault, optimizer as opt_lib, train_loop


def _mesh_axes(mesh_shape: tuple) -> tuple:
    if len(mesh_shape) == 2:
        return ("data", "model")
    if len(mesh_shape) == 1:
        return ("data",)
    raise ValueError(f"mesh_shape {tuple(mesh_shape)}: one or two axes")


def _train_mesh(mesh_shape: tuple, device="cuda"):
    """The ``DeviceMesh`` of ``mesh_shape`` over this process group, or
    ``None`` without one; a shape whose product is not the world size
    raises ``ValueError``."""
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    n = math.prod(mesh_shape)
    if n != world:
        raise ValueError(
            f"mesh_shape {tuple(mesh_shape)} holds {n} ranks, the world size is {world}"
        )
    if not dist.is_initialized():
        return None
    return make_device_mesh(tuple(mesh_shape), _mesh_axes(mesh_shape), device=device)


def train(
    arch: str,
    *,
    smoke: bool = True,
    steps: int = 50,
    batch: int = 8,
    seq: int = 64,
    ckpt_dir: str | None = None,
    ckpt_every: int = 25,
    mesh_shape: tuple[int, ...] = (1, 1),
    microbatches: int = 1,
    lr: float = 3e-3,
    log_every: int = 10,
    resume: bool = True,
    device="cuda",
) -> list[float]:
    """Train ``arch`` for ``steps`` steps (from the latest checkpoint in
    ``ckpt_dir`` with ``resume``); returns each step's ``loss_total``."""
    _mesh_axes(mesh_shape)
    dev = resolve_device(device)
    mesh = _train_mesh(mesh_shape, device)
    if mesh is not None:
        dev = rank_device(dist.get_rank(), device)
    rules.set_active_mesh(mesh)
    try:
        return _train(arch, mesh, dev, smoke=smoke, steps=steps, batch=batch, seq=seq,
                      ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, microbatches=microbatches,
                      lr=lr, log_every=log_every, resume=resume)
    finally:
        rules.set_active_mesh(None)


def _train(arch, mesh, dev, *, smoke, steps, batch, seq, ckpt_dir, ckpt_every,
           microbatches, lr, log_every, resume) -> list[float]:
    cfg = registry.get_config(arch, smoke=smoke)
    model = build_model(cfg)

    opt_cfg = opt_lib.AdamWConfig(lr=lr, warmup_steps=max(steps // 20, 5), total_steps=steps)
    step_fn = train_loop.build_train_step(model, opt_cfg, microbatches=microbatches)

    pipe = SyntheticLM(PipelineConfig(vocab=cfg.vocab_raw, seq_len=seq, global_batch=batch))

    params = model.trainable(model.init_params(seed=0, device=dev))
    if mesh is not None:
        spmd.distribute_params(params, mesh)
    opt_state = opt_lib.init_state(params)
    start = 0
    if ckpt_dir and resume:
        last = checkpoint.latest_step(ckpt_dir)
        if last is not None:
            params.load_state_dict(checkpoint.restore(ckpt_dir, last, params.state_dict()))
            opt_state = checkpoint.restore(ckpt_dir + "_opt", last, opt_state)
            start = last
            print(f"[train] resumed from step {start}")

    watchdog = fault.StragglerWatchdog()
    retry = fault.RetryPolicy()
    losses = []
    for step in range(start, steps):
        # a pure function of the step: exact replay after a resume
        batch_t = {k: torch.as_tensor(v, device=dev) for k, v in pipe.batch_at(step).items()}
        t0 = time.time()
        _, _, metrics = retry.run(lambda: step_fn(params, opt_state, batch_t))
        loss = float(metrics["loss_total"])  # waits for the step's device work
        dt = time.time() - t0
        if watchdog.observe(step, dt):
            print(f"[watchdog] step {step} straggled: {dt:.2f}s")
        losses.append(loss)
        if step % log_every == 0 or step == steps - 1:
            print(
                f"[train] step {step} loss {loss:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"lr {float(metrics['lr']):.2e} ({dt:.2f}s)"
            )
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            checkpoint.save(ckpt_dir, step + 1, params.state_dict())
            checkpoint.save(ckpt_dir + "_opt", step + 1, opt_state)
    return losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(registry.ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--mesh-shape", default="1,1")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args()
    shape = tuple(int(x) for x in args.mesh_shape.split(","))
    losses = train(
        args.arch,
        smoke=args.smoke,
        steps=args.steps,
        batch=args.batch,
        seq=args.seq,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        mesh_shape=shape,
        microbatches=args.microbatches,
        lr=args.lr,
        device=args.device,
    )
    print(f"[train] first loss {losses[0]:.4f} -> last loss {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
