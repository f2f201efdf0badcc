"""Mixture-of-Experts FFN with *sort-based dispatch* (port of
``src/repro/models/moe.py``).

This is where the paper's technique lands inside the transformer stack
(DESIGN.md §4): routing T tokens to E experts with a capacity bound is the
same partition-shuffle-process-concatenate problem ELSAR solves for
records.  The dispatch goes through the port's ``core.partition``:

  expert id        = bucket id (here from a learned router instead of a
                     learned CDF — both are order-preserving "models")
  bucket_matrix    = the (E, capacity) dispatch grid with sentinel slots
  counts/capacity  = the paper's equi-depth capacity argument: balanced
                     buckets are what make a small capacity factor safe
  combine          = the weighted scatter-back (concatenation analogue)

The aux metrics (Switch-style load balance, router z-loss, dropped
fraction) are the reference's.

On DTensors (a sharded step, ``sharding/spmd.py``) the dispatch and the
two index-adds run in ``local_map`` regions on replicated inputs — the
reference's global capacity over every token of the batch — and with
``REPRO_OPT_SHARDING`` the dispatched ``(E, C, D)`` slots and the
experts' outputs are pinned to the expert axis over "model" (expert
parallelism, the reference's constraints).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core import partition
from repro_torch.models import layers
from repro_torch.sharding import rules, spmd


class MoE(nn.Module):
    """Router, stacked expert weights ``(E, ...)`` and the optional shared
    experts (``init_moe``)."""

    def __init__(self, cfg, generator: torch.Generator | None = None, device=None):
        super().__init__()
        m = cfg.moe
        d, f, e = cfg.d_model, m.d_ff_expert, m.n_experts
        P = layers.param
        self.norm = P((d,), None, device, fill=1.0)
        self.router = P((d, e), generator, device)
        self.w_gate = P((e, d, f), generator, device)
        self.w_up = P((e, d, f), generator, device)
        self.w_down = P((e, f, d), generator, device)
        if m.n_shared > 0:
            self.shared = layers.MLP(d, f * m.n_shared, generator, device)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: descending, the lower index first on ties (a stable
    descending sort; ``torch.topk`` promises no tie order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p: MoE, cfg, xn: torch.Tensor):
    """Router over normed tokens xn (T, D): f32 logits (never rounded to
    bf16), softmax, the top-k probabilities (renormalised) and experts."""
    logits = xn.float() @ p.router.to(xn.dtype).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = top_k(probs, cfg.moe.top_k)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    return logits, probs, top_p, top_e


def apply_moe(p: MoE, cfg, x: torch.Tensor, *, capacity_factor: float | None = None):
    """x (B, S, D) -> (out (B, S, D), aux_metrics dict)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = m.n_experts, m.top_k
    cap_f = capacity_factor if capacity_factor is not None else m.capacity_factor
    capacity = _round_up(max(int(t * k / e * cap_f), 8), 8)

    # on DTensors: the tokens over the batch axes, so that the gradient
    # reaching this reshape comes back in a layout that splits into (B, S)
    xn = spmd.batch_layout(layers.rms_norm(x, p.norm, cfg.norm_eps).reshape(t, d))
    logits, probs, top_p, top_e = route(p, cfg, xn)

    # ---- sort-based dispatch (shared machinery with the ELSAR sorter)
    flat_e = top_e.reshape(t * k).to(torch.int32)
    gather_idx, valid, counts = spmd.on_replicas(
        lambda fe: partition.bucket_matrix(fe, e, capacity), 3, flat_e)
    gather_idx = gather_idx.to(torch.int64)
    token_of_slot = gather_idx // k  # (E, C) source token per dispatch slot
    # (E, C) combine weights (0 for padding/overflow)
    w_of_slot = torch.where(valid, top_p.reshape(t * k)[gather_idx], 0.0)
    xe = torch.where(valid[..., None], xn[token_of_slot], 0.0)  # (E, C, D)
    ep = rules.opt_sharding_enabled() and e % 16 == 0
    if ep:
        # expert parallelism: each rank runs its own experts' FFN, and the
        # dispatch and combine become all-to-all-shaped transfers
        xe = rules.constrain(xe, "model", None, None)

    dt = x.dtype
    g = torch.bmm(xe, p.w_gate.to(dt))
    u = torch.bmm(xe, p.w_up.to(dt))
    h = torch.bmm(layers.silu(g) * u, p.w_down.to(dt))
    if ep:
        h = rules.constrain(h, "model", None, None)

    # ---- combine (scatter-add back, weighted)
    # on DTensors the weighted slots are replicated before they are
    # flattened: the gradient then comes back through the flattening whole
    src = spmd.replicated(h * w_of_slot[..., None].to(dt))
    out = spmd.on_replicas(
        lambda idx, src: torch.zeros((t, d), dtype=dt, device=src.device).index_add_(
            0, idx, src),
        1, token_of_slot.reshape(-1), src.reshape(e * capacity, d),
    )
    if m.n_shared > 0:
        out = out + layers.apply_mlp(p.shared, xn)
    out = spmd.batch_layout(out)  # as xn, for the (B, S) split below

    # ---- aux losses / metrics (Switch LB + z-loss)
    me = probs.mean(0)  # (E,) mean router prob
    ce = spmd.on_replicas(
        lambda fe: torch.zeros(e, device=fe.device).index_add_(
            0, fe, torch.ones(t * k, device=fe.device)),
        1, flat_e,
    ) / (t * k)  # load fraction
    aux = {
        "moe_lb_loss": e * torch.sum(me * ce),
        "moe_z_loss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
        "moe_dropped_frac": torch.clamp_min(counts - capacity, 0).sum()
        / max(t * k, 1),
    }
    # on DTensors: reduced scalars, so that layers' terms add up
    aux = {name: spmd.replicated(val) for name, val in aux.items()}
    return x + out.reshape(b, s, d), aux
