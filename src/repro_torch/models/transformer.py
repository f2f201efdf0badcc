"""Decoder-LM assembly: layers, train / prefill / decode paths, embeddings
and the LM head (port of ``src/repro/models/transformer.py``).

Layer plan (configs/base.py ``layer_plan``): a list of groups, each a
*period* of sublayers repeated ``n_repeat`` times.  The reference stacks a
group's parameters on a leading axis and ``lax.scan``s over it; the port
keeps one module per layer (``Transformer.layers[i]``, a ``ModuleDict``
of the period's sublayers under the reference's slot names) and loops.

The training path (``forward``/``loss_fn`` with ``remat=True``, the
reference's ``jax.checkpoint`` around each period) runs each layer under
``torch.utils.checkpoint``: autograd keeps a layer's input and recomputes
its activations in the backward pass.

Sublayer kinds: ``attn``, ``attn_swa``, ``attn_bidir``, ``cross``,
``mlp``, ``moe``, ``mamba``, ``mlstm`` and ``slstm``; the ``vit``
frontend stub.  Encoder-decoder models assemble these sublayers in
``models/encdec.py``.

The sliding-window cache differs from the reference's on purpose: the
reference's prefill keeps ``k[:, -window:]`` (the prompt token ``t`` at
slot ``t - (P - window)``, and a ring only ``P`` long when ``P < window``)
while its decode writes at ``pos % window``, so its decode attends to the
wrong tokens unless the prompt length is a multiple of the window
(ROADMAP Queue 3).  Here the ring has ``min(max_seq, window)`` slots and
token ``t`` lives at ``t % ring`` from prefill on.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.executor import resolve_device
from repro_torch.models import attention, layers, mamba, moe, recurrence, xlstm
from repro_torch.sharding import spmd

RECURRENT_KINDS = ("mamba", "mlstm", "slstm")
_RECURRENT = {"mamba": mamba.apply_mamba, "mlstm": xlstm.apply_mlstm,
              "slstm": xlstm.apply_slstm}


def _slot(i: int, kind: str) -> str:
    return f"{i:02d}_{kind}"


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def init_sublayer(kind: str, cfg, generator=None, device=None) -> nn.Module:
    if kind in ("attn", "attn_swa", "attn_bidir", "cross"):
        return attention.Attention(cfg, generator, device, cross=kind == "cross")
    if kind == "mlp":
        return layers.MLP(cfg.d_model, cfg.d_ff, generator, device, norm=True)
    if kind == "moe":
        return moe.MoE(cfg, generator, device)
    if kind == "mamba":
        return mamba.Mamba(cfg, generator, device)
    if kind == "mlstm":
        return xlstm.MLSTM(cfg, generator, device)
    if kind == "slstm":
        return xlstm.SLSTM(cfg, generator, device)
    raise ValueError(kind)


def stack_layers(cfg, plan, generator=None, device=None):
    """A layer plan's modules, one ``ModuleDict`` of the period's
    sublayers a layer, and each layer's period."""
    mods, periods = nn.ModuleList(), []
    for n_repeat, period in plan:
        for _ in range(n_repeat):
            mods.append(nn.ModuleDict({
                _slot(i, kind): init_sublayer(kind, cfg, generator, device)
                for i, kind in enumerate(period)
            }))
            periods.append(period)
    return mods, periods


class Frontend(nn.Module):
    """The ``vit`` stub's projector: precomputed patch embeddings →
    ``d_model``."""

    def __init__(self, cfg, generator=None, device=None):
        super().__init__()
        self.proj1 = layers.param((cfg.d_frontend, cfg.d_model), generator, device)
        self.proj2 = layers.param((cfg.d_model, cfg.d_model), generator, device)


class Transformer(nn.Module):
    """The port's parameters: f32, frozen until ``Model.trainable``, one
    module per layer.

    With ``generator=None`` the weights are left empty, to be filled by
    ``load_state_dict`` (e.g. from ``convert.from_jax_params``)."""

    def __init__(self, cfg, generator: torch.Generator | None = None, device=None):
        super().__init__()
        d, v = cfg.d_model, cfg.vocab
        self.embed = layers.param((v, d), generator, device)
        self.final_norm = layers.param((d,), None, device, fill=1.0)
        if not cfg.tie_embeddings:
            self.lm_head = layers.param((d, v), generator, device)
        if cfg.frontend == "vit":
            self.frontend = Frontend(cfg, generator, device)
        self.layers, self.periods = stack_layers(cfg, cfg.layer_plan(), generator, device)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_params(cfg, seed: int = 0, device="cuda") -> Transformer:
    """Seeded random parameters on ``device`` (a ``torch.Generator`` there;
    the numbers differ from the reference's ``jax.random`` ones)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return Transformer(cfg, gen, dev)


@dataclasses.dataclass
class Cache:
    """Decode state: per layer, per stateful slot, a dict of tensors
    updated in place — an attention slot's ``{"k", "v"}`` bf16
    ``(B, S_max | ring, K, hd)`` (cross: the encoder's ``(B, T, K, hd)``),
    a recurrent slot's state (``mamba.init_mamba_cache``,
    ``xlstm.init_mlstm_cache``, ``xlstm.init_slstm_cache``); ``pos`` is
    the next write position."""

    layers: list[dict[str, dict[str, torch.Tensor]]]
    pos: int = 0


def init_sublayer_cache(kind: str, cfg, batch: int, max_seq: int, device=None):
    if kind in ("attn", "attn_swa"):
        cap = min(max_seq, cfg.window) if kind == "attn_swa" and cfg.window else max_seq
        return attention.init_cache(cfg, batch, cap, device=device)
    if kind == "cross":
        return attention.init_cache(cfg, batch, cfg.n_frontend_tokens or 1, device=device)
    if kind == "mamba":
        return mamba.init_mamba_cache(cfg, batch, device=device)
    if kind == "mlstm":
        return xlstm.init_mlstm_cache(cfg, batch, device)
    if kind == "slstm":
        return xlstm.init_slstm_cache(cfg, batch, device)
    return None  # attn_bidir / mlp / moe keep no decode state


def init_cache(cfg, batch: int, max_seq: int, device=None, mesh=None) -> Cache:
    """Zeroed decode state; on ``mesh`` each tensor is a DTensor laid out
    by ``rules.cache_spec`` (sequence-sharded when the batch is 1, as the
    reference's dry run lays out its long-context cells), built from one
    row expanded over the batch, so that no rank holds the whole cache."""
    rows = batch if mesh is None else 1
    out = []
    for n_repeat, period in cfg.layer_plan():
        for _ in range(n_repeat):
            ch = {}
            for i, kind in enumerate(period):
                c = init_sublayer_cache(kind, cfg, rows, max_seq, device)
                if c is not None and mesh is not None:
                    c = {k: t.expand(batch, *t.shape[1:]) for k, t in c.items()}
                if c is not None:
                    ch[_slot(i, kind)] = c
            out.append(ch)
    cache = Cache(out)
    if mesh is not None:
        spmd.shard_cache(cache, mesh, seq_sharded=batch == 1)
    return cache


# ---------------------------------------------------------------------------
# sublayer dispatch
# ---------------------------------------------------------------------------


def apply_sublayer_seq(kind: str, p, cfg, x, positions, *, want_kv: bool = False):
    """Full-sequence path (train / prefill). Returns (x, (k, v)|None, aux)."""
    aux, kv = {}, None
    x = spmd.batch_layout(x)
    if kind in ("attn", "attn_swa", "attn_bidir"):
        window = cfg.window if kind == "attn_swa" else 0
        causal = kind != "attn_bidir"
        if want_kv:
            x, kv = attention.attend_full(
                p, cfg, x, positions, causal=causal, window=window, return_kv=True
            )
        else:
            x = attention.attend_full(p, cfg, x, positions, causal=causal, window=window)
    elif kind == "mlp":
        xn = layers.rms_norm(x, p.norm, cfg.norm_eps)
        x = x + layers.apply_mlp(p, xn)
    elif kind == "moe":
        x, aux = moe.apply_moe(p, cfg, x)
    elif kind in RECURRENT_KINDS:
        apply = _RECURRENT[kind]
        x, _ = spmd.batch_local(lambda m, xx, _: (apply(m, cfg, xx), None), p, x)
    else:
        raise ValueError(kind)
    return x, kv, aux


def apply_sublayer_step(kind: str, p, cfg, x, cache, pos: int):
    """Single-token decode path; caches are updated in place."""
    x = spmd.batch_layout(x)
    if kind == "attn":
        return attention.attend_decode(p, cfg, x, cache, pos)
    if kind == "attn_swa":  # layer_plan gives it only where window > 0
        return attention.attend_rolling(p, cfg, x, cache, pos)
    if kind == "cross":
        return attention.attend_cross(p, cfg, x, cache)
    if kind == "mlp":
        xn = layers.rms_norm(x, p.norm, cfg.norm_eps)
        return x + layers.apply_mlp(p, xn)
    if kind == "moe":
        x, _ = moe.apply_moe(p, cfg, x, capacity_factor=4.0)
        return x
    if kind in RECURRENT_KINDS:
        if not spmd.is_dtensor(x):
            return _RECURRENT[kind](p, cfg, x, cache)
        x, state = spmd.batch_local(lambda m, xx, c: _step_local(kind, m, cfg, xx, c),
                                    p, x, dict(cache))
        cache.update(state)
        return x
    raise ValueError(kind)


def _step_local(kind: str, p, cfg, x, cache: dict):
    """One recurrent decode step on plain tensors: (x, the new state)."""
    cache = dict(cache)
    return _RECURRENT[kind](p, cfg, x, cache), cache


# ---------------------------------------------------------------------------
# forward paths
# ---------------------------------------------------------------------------


def embed_inputs(cfg, params: Transformer, tokens, frontend_embeds=None):
    # gather, then cast: the reference's cast-then-gather, without casting
    # the whole table
    x = spmd.gather_rows(params.embed, tokens.to(torch.int64)).to(layers.COMPUTE_DTYPE)
    if cfg.frontend == "vit" and frontend_embeds is not None:
        fr = params.frontend
        f = frontend_embeds.to(layers.COMPUTE_DTYPE)
        f = layers.gelu(f @ fr.proj1.to(f.dtype))
        f = f @ fr.proj2.to(f.dtype)
        x = torch.cat([f, x], dim=1)
    return x


def lm_logits(cfg, params: Transformer, x: torch.Tensor) -> torch.Tensor:
    """Final norm, then the head in f32 on bf16-rounded operands."""
    x = layers.rms_norm(spmd.batch_layout(x), params.final_norm, cfg.norm_eps)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    # on DTensors: the head gathered over d_model (else DTensor may gather
    # the activations and leave the logits a partial sum), then each
    # rank's rows of the batch with the vocab whole, so that the softmax
    # and the loss stay on the batch shard
    head = spmd.gather_dim(head, 0)
    return spmd.batch_layout(x.float() @ head.to(x.dtype).float())


def _positions(s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None, :]


def run_layer(remat: bool, fn, *args):
    """``fn(*args)``; with ``remat``, while autograd records, under
    ``torch.utils.checkpoint`` (non-reentrant): only ``args`` are kept,
    and ``fn`` runs again in the backward pass."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _layer_seq(cfg, layer, period, x, positions):
    """One layer's sublayers in order -> (x, each MoE sublayer's aux)."""
    auxs = []
    for i, kind in enumerate(period):
        x, _, aux = apply_sublayer_seq(kind, layer[_slot(i, kind)], cfg, x, positions)
        if aux:
            auxs.append(aux)
    return x, auxs


def forward(cfg, params: Transformer, tokens, frontend_embeds=None, *,
            remat: bool = True):
    """Full-sequence logits (f32) and the MoE aux metrics summed over
    layers; ``remat`` recomputes each layer in the backward pass."""
    x = embed_inputs(cfg, params, tokens, frontend_embeds)
    positions = _positions(x.shape[1], x.device)
    aux_total = {"moe_lb_loss": 0.0, "moe_z_loss": 0.0, "moe_dropped_frac": 0.0}
    for layer, period in zip(params.layers, params.periods):
        x, auxs = run_layer(remat, _layer_seq, cfg, layer, period, x, positions)
        for aux in auxs:
            for k, val in aux.items():
                aux_total[k] = aux_total[k] + val
    return lm_logits(cfg, params, x), aux_total


def loss_fn(cfg, params: Transformer, batch: dict, *, remat: bool = True):
    """Next-token cross-entropy (+ MoE aux), differentiable in the
    parameters.  batch: tokens (B, S) [+ frontend_embeds]; frontend
    positions are excluded."""
    tokens = batch["tokens"]
    logits, aux = forward(cfg, params, tokens, batch.get("frontend_embeds"),
                          remat=remat)
    n_front = logits.shape[1] - tokens.shape[1]
    logits_text = logits[:, n_front:, :]
    tgt = tokens[:, 1:].to(torch.int64)
    loss = spmd.on_batch_rows(token_nll, logits_text, tgt).mean()
    total = loss + 0.01 * aux["moe_lb_loss"] + 0.001 * aux["moe_z_loss"]
    return total, {"loss": loss, **aux}


def token_nll(logits, tgt):
    """Each next token's negative log-likelihood (B, S-1) under logits
    (B, S, V), in f32."""
    lp = F.log_softmax(logits[:, :-1].float(), dim=-1)
    return -torch.gather(lp, -1, tgt[..., None])[..., 0]


def prefill(cfg, params: Transformer, tokens, frontend_embeds=None,
            max_seq: int | None = None):
    """Run the full prompt, return (last_logits f32 (B, V), cache ready for
    decode at ``pos = S``).  The cache holds ``max_seq`` slots (the prompt's
    length if None); a sliding-window layer's ring holds
    ``min(max_seq, window)``, token ``t`` at slot ``t % ring``.  Recurrent
    sublayers leave their final state (``_prefill_recurrent``)."""
    x = embed_inputs(cfg, params, tokens, frontend_embeds)
    s = x.shape[1]
    max_seq = s if max_seq is None else max_seq
    if max_seq < s:
        raise ValueError(f"max_seq {max_seq} is shorter than the prompt ({s})")
    positions = _positions(s, x.device)
    cache = init_cache(cfg, x.shape[0], max_seq, x.device, spmd.mesh_of(x))
    for layer, period, lcache in zip(params.layers, params.periods, cache.layers):
        for i, kind in enumerate(period):
            slot = _slot(i, kind)
            if kind in RECURRENT_KINDS:
                x = _prefill_recurrent(kind, layer[slot], cfg, x, lcache[slot])
                continue
            x, kv, _ = apply_sublayer_seq(
                kind, layer[slot], cfg, x, positions, want_kv=slot in lcache
            )
            if kv is not None:
                ring = kind == "attn_swa" and cfg.window > 0
                attention.fill_cache(lcache[slot], *kv, ring=ring)
    cache.pos = s
    return lm_logits(cfg, params, x[:, -1]), cache


def _prefill_recurrent(kind: str, p, cfg, x, cache: dict):
    """Sequence forward of a recurrent sublayer that leaves its final
    state in ``cache``: mamba's chunked scan with ``return_state``; mLSTM
    and sLSTM step the recurrence token by token from the initial state,
    as the reference does (``recurrence.scan``).  On DTensors each rank
    runs its rows of the batch (``spmd.batch_local``)."""
    x = spmd.batch_layout(x)
    x, state = spmd.batch_local(lambda m, xx, c: _prefill_local(kind, m, cfg, xx, c),
                                p, x, dict(cache))
    cache.update(state)
    return x


def _prefill_local(kind: str, p, cfg, x, cache: dict):
    """:func:`_prefill_recurrent` on plain tensors: (x, the final state)."""
    if kind == "mamba":
        return mamba.apply_mamba(p, cfg, x, return_state=True)
    step = xlstm.apply_mlstm if kind == "mlstm" else xlstm.apply_slstm

    def token(c, xt):
        return c, step(p, cfg, xt, c)

    cache, y = recurrence.scan(token, dict(cache), x, keepdim=True)
    return y, cache


def decode_logits(cfg, params: Transformer, cache: Cache, tokens) -> torch.Tensor:
    """One decode step's f32 logits (B, 1, V); advances ``cache``."""
    x = embed_inputs(cfg, params, tokens)
    for layer, period, lcache in zip(params.layers, params.periods, cache.layers):
        for i, kind in enumerate(period):
            slot = _slot(i, kind)
            x = apply_sublayer_step(kind, layer[slot], cfg, x, lcache.get(slot), cache.pos)
    cache.pos += 1
    return lm_logits(cfg, params, x)


def decode_step(cfg, params: Transformer, cache: Cache, tokens):
    """One greedy decode step. tokens (B, 1) -> (next (B, 1) int32, cache)."""
    logits = spmd.gather_dim(decode_logits(cfg, params, cache, tokens), -1)
    return torch.argmax(logits, dim=-1).to(torch.int32), cache
