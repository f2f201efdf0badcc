"""AdamW + cosine schedule with warmup (port of
``src/repro/train/optimizer.py``).

The reference's arithmetic, op for op: ``torch.optim.AdamW`` folds the
bias corrections into the step size and rounds in another order.  The
update runs in place, one leaf at a time, with at most two f32
temporaries of a leaf alive (qwen3-4b's ``embed`` and ``lm_head`` are
389M elements each).  Every operation is an f32 tensor op rounded on its
own, as the reference's unjitted update rounds; the scalars (learning
rate, bias corrections) are f32 tensors on the parameters' device, so a
division on the card divides (a CPU scalar divisor is multiplied by its
reciprocal there).

``params`` is a dict of name → tensor (``dict(module.named_parameters())``)
or a module; the state is ``{"step", "m", "v"}``, ``m`` and ``v`` keyed by
the same names, ``step`` a 0-d int32 tensor.  Gradient clipping is by
global norm; the gradients come in bf16 (``train_loop`` rounds them) and
are taken up to f32 here.

On DTensors (a sharded step) the parameters, ``m``, ``v`` and the
gradients share each leaf's layout, and the update runs on the local
shards.  The global norm sums every rank's local squares, each weighed
by 1 / (the ranks holding a copy of that shard), in one all-reduce over
the mesh, so every rank clips by the same scale.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def named(params) -> dict[str, torch.Tensor]:
    """``params`` as a dict of name → tensor (a module's parameters)."""
    return dict(params.named_parameters()) if isinstance(params, nn.Module) else params


def init_state(params) -> dict:
    leaves = named(params)
    return {
        "step": torch.zeros((), dtype=torch.int32),
        "m": {n: torch.zeros_like(p, dtype=torch.float32) for n, p in leaves.items()},
        "v": {n: torch.zeros_like(p, dtype=torch.float32) for n, p in leaves.items()},
    }


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor), an f32 0-d
    tensor: linear warmup, then cosine decay to ``min_lr_frac``."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp(
        (s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0,
        1.0,
    )
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog)
    )
    return cfg.lr * torch.minimum(warm, cos)


def _local(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (a view: in-place writes land in it)."""
    from repro_torch.sharding import spmd

    return x.to_local() if spmd.is_dtensor(x) else x


def global_norm(grads: dict) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares; of
    DTensor gradients (in ``Shard``/``Replicate`` layouts), a plain
    tensor every rank agrees on."""
    from repro_torch.sharding import spmd

    total, mesh = None, None
    for g in grads.values():
        sq = torch.sum(torch.square(_local(g).float()))
        if spmd.is_dtensor(g):
            mesh = g.device_mesh
            copies = 1
            for i, pl in enumerate(g.placements):
                copies *= 1 if pl.is_shard() else mesh.size(i)
            if copies > 1:
                sq = sq / copies
        total = sq if total is None else total + sq
    if mesh is not None:
        from torch.distributed.tensor import DTensor, Partial

        total = DTensor.from_local(
            total, mesh, [Partial()] * mesh.ndim, run_check=False).full_tensor()
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads: dict, state: dict):
    """One AdamW step in place: ``params``, ``state["m"]`` and
    ``state["v"]`` are updated leaf by leaf, then ``state["step"]``.
    Returns ``(params, state, {"grad_norm", "lr"})``."""
    leaves = named(params)
    dev = _local(next(iter(leaves.values()))).device
    step = state["step"].cpu() + 1
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / (gnorm + 1e-9), 1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    sf = step.to(torch.float32)
    bc1 = (1 - torch.tensor(b1, dtype=torch.float32) ** sf).to(dev)
    bc2 = (1 - torch.tensor(b2, dtype=torch.float32) ** sf).to(dev)
    lr_dev = lr.to(dev)

    for name, p in leaves.items():
        p, m, v = _local(p), _local(state["m"][name]), _local(state["v"][name])
        g = _local(grads[name]).to(torch.float32, copy=True).mul_(scale)
        t = torch.mul(g, 1 - b1)
        m.mul_(b1).add_(t)  # m2 = b1 * m + (1 - b1) * g
        torch.mul(g, 1 - b2, out=t).mul_(g)
        v.mul_(b2).add_(t)  # v2 = b2 * v + (1 - b2) * g * g
        torch.div(m, bc1, out=t)  # mh
        torch.div(v, bc2, out=g).sqrt_().add_(cfg.eps)  # sqrt(vh) + eps
        t.div_(g)
        torch.mul(p, cfg.weight_decay, out=g)
        t.add_(g).mul_(lr_dev)  # lr * delta
        p.sub_(t)
        del g, t
    state["step"] = step.to(torch.int32)
    return params, state, {"grad_norm": gnorm, "lr": lr}
