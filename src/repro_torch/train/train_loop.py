"""Train step builder (port of ``src/repro/train/train_loop.py``): remat
per layer (inside the model's ``loss_fn``), microbatch gradient
accumulation, bf16 gradient rounding, AdamW.

The reference's step is a pure ``(params, opt_state, batch) -> (params,
opt_state, metrics)``; the port's updates ``params`` (a module, its
parameters marked by ``Model.trainable``) and ``opt_state`` in place and
returns the same three.  Nothing is updated before every gradient is
complete, and every gradient is computed afresh from the step's inputs,
so a step that raised before its update (``fault.RetryPolicy`` retries
``RuntimeError``/``OSError``) can be run again from the same arguments.

Sharded (``sharding/spmd.py``): the parameters and the optimizer state
are DTensors laid out by ``rules.param_specs``, the batch by
``rules.data_spec``, and the step runs the model's code on them under
DTensor's sharding propagation.  The gradients of the model's bf16
weight copies are bf16, so the cross-replica reductions DTensor inserts
in the backward pass move bf16; each gradient is then pinned to its
parameter's layout, and so is the microbatch accumulator (the port's
counterpart of the reference's ``param_shardings``, which pins them to
the parameters' shardings); the update gets each gradient in its
parameter's layout.  The metrics come back reduced.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from repro_torch.sharding import spmd
from repro_torch.train import optimizer as opt_lib


class _GradsOf(nn.Module):
    """``model.loss_fn`` over ``params`` and its gradients with respect to
    ``leaves``, as a module's forward: under ``torch.func.functional_call``
    with ``leaves`` swapped in for ``params``' own, so that the remat
    recomputation inside the backward pass sees them too."""

    def __init__(self, model, params: nn.Module):
        super().__init__()
        self.model, self.params = model, params

    def forward(self, batch, leaves):
        loss, _ = self.model.loss_fn(self.params, batch)
        return loss.detach(), torch.autograd.grad(loss, leaves, allow_unused=True)


def _pin(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient redistributed to ``p``'s placements: a
    ``Partial`` sum is reduced there, in ``g``'s dtype."""
    if not spmd.is_dtensor(g):
        return g
    want = tuple(p.placements)
    return g if tuple(g.placements) == want else g.redistribute(p.device_mesh, want)


def grads_of(model, params: nn.Module, batch: dict, *, microbatches: int = 1):
    """``(loss, metrics, grads)``: the loss, the model's metrics (none
    with ``microbatches > 1``, as in the reference) and each parameter's
    gradient rounded to bf16 (the reference's gradient compression),
    keyed by parameter name.  Each f32 gradient is rounded as soon as
    autograd has finished it (a post-accumulate hook), so at most a
    layer's f32 gradients are alive at once; a parameter the loss does
    not reach (the vit projector without image inputs) gets zeros, as
    ``jax.grad`` gives."""
    if microbatches > 1:
        loss, grads = _micro_grads(model, params, batch, microbatches)
        return loss, {}, grads
    leaves = dict(params.named_parameters())
    grads: dict[str, torch.Tensor] = {}

    def keep(name):
        def hook(p):
            grads[name] = _pin(p.grad.to(torch.bfloat16), p)
            p.grad = None
        return hook

    for p in leaves.values():
        p.grad = None  # a step retried after a failed backward starts clean
    handles = [p.register_post_accumulate_grad_hook(keep(n)) for n, p in leaves.items()]
    try:
        loss, metrics = model.loss_fn(params, batch)
        loss.backward()
    finally:
        for h in handles:
            h.remove()
    for n, p in leaves.items():
        if n not in grads:
            grads[n] = torch.zeros_like(p, dtype=torch.bfloat16)
    return (loss.detach(), {k: torch.as_tensor(v).detach() for k, v in metrics.items()},
            grads)


def _micro_grads(model, params: nn.Module, batch: dict, microbatches: int):
    """The microbatched gradients: taken against one bf16 copy of every
    f32 leaf of rank >= 2 (the reference's ``cast_params``), summed in
    f32 over the microbatches, divided, rounded to bf16; and the mean
    loss."""
    leaves = dict(params.named_parameters())
    with torch.no_grad():
        cast = {n: (p.to(torch.bfloat16) if p.dtype == torch.float32 and p.dim() >= 2
                    else p.detach().clone()).requires_grad_(True)
                for n, p in leaves.items()}
    grads_of_mb = _GradsOf(model, params)
    swapped = {f"params.{n}": t for n, t in cast.items()}
    # the accumulator in the parameters' layout
    g_sum = {n: _pin(torch.zeros_like(p, dtype=torch.float32), p)
             for n, p in leaves.items()}
    l_sum = 0.0
    for i in range(microbatches):
        mb = {k: _microbatch(v, i, microbatches) for k, v in batch.items()}
        loss, gs = torch.func.functional_call(
            grads_of_mb, swapped, (mb, list(cast.values())))
        for n, g in zip(cast, gs):
            if g is not None:
                g_sum[n].add_(_pin(g.to(torch.bfloat16), leaves[n]).float())
        l_sum = l_sum + loss
    grads = {n: (g / microbatches).to(torch.bfloat16) for n, g in g_sum.items()}
    return l_sum / microbatches, grads


def _microbatch(v: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Microbatch ``i`` of ``n``: rows ``i*b..`` of the batch; of a batch
    DTensor, rows ``i*b..`` of each rank's shard (the same examples in
    all, grouped otherwise: the mean gradient over the microbatches is
    the same, and no rank's rows move)."""
    if spmd.is_dtensor(v) and v.placements and any(p.is_shard(0) for p in v.placements):
        from torch.distributed.tensor import DTensor

        loc = v.to_local()
        b = loc.shape[0] // n
        return DTensor.from_local(loc[i * b:(i + 1) * b], v.device_mesh, v.placements,
                                  run_check=False)
    return v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]


def build_train_step(model, opt_cfg: opt_lib.AdamWConfig, *,
                     microbatches: int = 1) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``metrics`` holds ``loss_total``, ``grad_norm`` and
    ``lr``, plus the model's metrics (``loss``, the MoE aux terms) when
    ``microbatches == 1``, as plain tensors (reduced over the mesh).
    With DTensor parameters the batch's plain tensors are laid out by
    ``rules.data_spec`` first."""

    def train_step(params, opt_state, batch):
        mesh = spmd.mesh_of(next(params.parameters()))
        if mesh is not None:
            batch = spmd.shard_batch(
                {k: v for k, v in batch.items() if not spmd.is_dtensor(v)}, mesh
            ) | {k: v for k, v in batch.items() if spmd.is_dtensor(v)}
        with spmd.maybe_sharded(mesh):
            loss, metrics, grads = grads_of(model, params, batch, microbatches=microbatches)
            params, opt_state, om = opt_lib.apply_updates(opt_cfg, params, grads, opt_state)
        metrics = {k: spmd.full(v) for k, v in {**metrics, **om, "loss_total": loss}.items()}
        return params, opt_state, metrics

    return train_step


def build_serve_step(model) -> Callable:
    """(params, cache, tokens) -> (next_tokens, cache) — one decode step."""

    def serve_step(params, cache, tokens):
        with torch.inference_mode():
            return model.decode_step(params, cache, tokens)

    return serve_step


def build_prefill(model) -> Callable:
    def prefill(params, batch):
        with torch.inference_mode():
            return model.prefill(params, batch)

    return prefill
