"""Whisper-style encoder-decoder (port of ``src/repro/models/encdec.py``):
the backbone only; the mel/conv frontend is a stub, and precomputed
frame embeddings (B, n_frames, d_model) come in as ``frontend_embeds``.

The reference stacks each of the encoder's and the decoder's groups on a
leading axis (``enc_groups``, ``dec_groups``) and ``lax.scan``s over it;
the port keeps one ``ModuleDict`` a layer (``EncDec.enc_layers[i]``, and
the decoder's ``EncDec.layers[i]`` as in a decoder-only ``Transformer``)
under the reference's slot names, and loops.  The decoder's cache
(``transformer.Cache``) holds each layer's self-attention K/V, written in
place, and its cross K/V from the encoder; a decode step is the
decoder-only model's (``transformer.decode_logits``), whose ``cross``
sublayer attends to that K/V.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.executor import resolve_device
from repro_torch.models import attention, layers, transformer
from repro_torch.models.transformer import _slot
from repro_torch.sharding import spmd


def enc_plan(cfg):
    return [(cfg.n_enc_layers, ("attn_bidir", "mlp"))]


class EncDec(nn.Module):
    """The port's enc-dec parameters: f32, frozen until
    ``Model.trainable``, one module a layer.
    With ``generator=None`` the weights are left empty, to be filled by
    ``load_state_dict`` (e.g. from ``convert.from_jax_params``)."""

    def __init__(self, cfg, generator: torch.Generator | None = None, device=None):
        super().__init__()
        d, v = cfg.d_model, cfg.vocab
        self.embed = layers.param((v, d), generator, device)
        self.enc_norm = layers.param((d,), None, device, fill=1.0)
        self.final_norm = layers.param((d,), None, device, fill=1.0)
        self.lm_head = layers.param((d, v), generator, device)
        self.enc_layers, self.enc_periods = transformer.stack_layers(
            cfg, enc_plan(cfg), generator, device)
        self.layers, self.periods = transformer.stack_layers(
            cfg, cfg.layer_plan(), generator, device)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_params(cfg, seed: int = 0, device="cuda") -> EncDec:
    """Seeded random parameters on ``device`` (the numbers differ from the
    reference's ``jax.random`` ones)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return EncDec(cfg, gen, dev)


def _enc_layer(cfg, layer, period, x, positions):
    for i, kind in enumerate(period):
        x, _, _ = transformer.apply_sublayer_seq(
            kind, layer[_slot(i, kind)], cfg, x, positions
        )
    return x


def encode(cfg, params: EncDec, frames) -> torch.Tensor:
    """frames (B, T, D) stub embeddings -> encoder states (B, T, D); each
    layer recomputed in the backward pass, as the reference always does."""
    x = frames.to(layers.COMPUTE_DTYPE)
    x = x + layers.sinusoidal_positions(x.shape[1], cfg.d_model).to(x.device, x.dtype)
    positions = transformer._positions(x.shape[1], x.device)
    for layer, period in zip(params.enc_layers, params.enc_periods):
        x = transformer.run_layer(True, _enc_layer, cfg, layer, period, x, positions)
    return layers.rms_norm(x, params.enc_norm, cfg.norm_eps)


def cross_caches(cfg, params: EncDec, enc_out) -> list[dict]:
    """Each decoder layer's cross K/V: ``[{slot: {"k", "v"}}]``."""
    return [
        {_slot(i, kind): attention.encode_cross_kv(layer[_slot(i, kind)], cfg, enc_out)
         for i, kind in enumerate(period) if kind == "cross"}
        for layer, period in zip(params.layers, params.periods)
    ]


def _dec_layer(cfg, layer, period, lcross, x, positions):
    for i, kind in enumerate(period):
        slot = _slot(i, kind)
        if kind == "cross":
            x = attention.attend_cross(layer[slot], cfg, x, lcross[slot])
        else:
            x, _, _ = transformer.apply_sublayer_seq(kind, layer[slot], cfg, x, positions)
    return x


def decoder_forward(cfg, params: EncDec, tokens, cross: list[dict], *,
                    remat: bool = True) -> torch.Tensor:
    """Teacher-forced decoder: f32 logits (B, S, V); ``remat`` recomputes
    each layer in the backward pass."""
    x = transformer.embed_inputs(cfg, params, tokens)
    positions = transformer._positions(x.shape[1], x.device)
    for layer, period, lcross in zip(params.layers, params.periods, cross):
        x = transformer.run_layer(remat, _dec_layer, cfg, layer, period, lcross, x,
                                  positions)
    return transformer.lm_logits(cfg, params, x)


def forward(cfg, params: EncDec, tokens, frames, *, remat: bool = True):
    """Full-sequence logits through the encoder and the decoder, and no
    aux metrics (the counterpart of ``transformer.forward``)."""
    enc = encode(cfg, params, frames)
    return decoder_forward(cfg, params, tokens, cross_caches(cfg, params, enc),
                           remat=remat), {}


def loss_fn(cfg, params: EncDec, batch: dict, *, remat: bool = True):
    """Next-token cross-entropy, differentiable in the parameters."""
    tokens = batch["tokens"]
    logits, _ = forward(cfg, params, tokens, batch["frontend_embeds"], remat=remat)
    tgt = tokens[:, 1:].to(torch.int64)
    loss = spmd.on_batch_rows(transformer.token_nll, logits, tgt).mean()
    return loss, {"loss": loss}


# the decoder's cache and step are the decoder-only model's: ``init_cache``
# gives attn slots ``max_seq`` zero K/V and cross slots ``n_frontend_tokens``
# (filled by ``prefill``)
init_cache = transformer.init_cache
decode_logits = transformer.decode_logits
decode_step = transformer.decode_step


def prefill(cfg, params: EncDec, tokens, frames, max_seq: int | None = None):
    """Encoder pass + decoder prompt pass -> (last logits f32 (B, V),
    cache ready for decode at ``pos = S``)."""
    cross = cross_caches(cfg, params, encode(cfg, params, frames))
    x = transformer.embed_inputs(cfg, params, tokens)
    s = x.shape[1]
    max_seq = s if max_seq is None else max_seq
    if max_seq < s:
        raise ValueError(f"max_seq {max_seq} is shorter than the prompt ({s})")
    positions = transformer._positions(s, x.device)
    cache = init_cache(cfg, x.shape[0], max_seq, x.device, spmd.mesh_of(x))
    for layer, period, lcross, lcache in zip(params.layers, params.periods, cross,
                                             cache.layers):
        for i, kind in enumerate(period):
            slot = _slot(i, kind)
            if kind == "cross":
                lcache[slot] = lcross[slot]
                x = attention.attend_cross(layer[slot], cfg, x, lcross[slot])
                continue
            x, kv, _ = transformer.apply_sublayer_seq(
                kind, layer[slot], cfg, x, positions, want_kv=slot in lcache
            )
            if kv is not None:
                attention.fill_cache(lcache[slot], *kv, ring=False)
    cache.pos = s
    return transformer.lm_logits(cfg, params, x[:, -1]), cache
