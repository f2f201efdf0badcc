"""Public model API (port of ``src/repro/models/api.py``): ``build_model(cfg)``
returns a ``Model`` facade with init / forward / loss / prefill / decode
(and ``trainable``, which marks parameters for the trainer),
over ``models/transformer.py`` for decoder-only models and
``models/encdec.py`` for encoder-decoder ones (whose batches carry the
frame embeddings as ``frontend_embeds``).

The dry-run specs (``input_specs``, ``params_spec``, ``cache_spec``) are
tensors on the ``meta`` device: shapes and dtypes, nothing allocated.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.executor import resolve_device
from repro_torch.models import encdec, transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    @property
    def _impl(self):
        return encdec if self.cfg.enc_dec else transformer

    def init_params(self, seed: int = 0, device="cuda") -> nn.Module:
        return self._impl.init_params(self.cfg, seed, device)

    def load_params(self, state_dict: dict, device="cuda") -> nn.Module:
        """The model's parameters on ``device`` holding ``state_dict`` (e.g.
        from ``convert.from_jax_params``)."""
        cls = encdec.EncDec if self.cfg.enc_dec else transformer.Transformer
        params = cls(self.cfg, device=resolve_device(device))
        params.load_state_dict(state_dict)
        return params

    def trainable(self, params: nn.Module) -> nn.Module:
        """Mark every parameter of ``params`` trained (``requires_grad``),
        in place: ``loss_fn`` then records the graph its backward pass
        needs.  Parameters are built frozen, so serving records none."""
        return params.requires_grad_(True)

    def forward(self, params, batch: dict):
        """Full-sequence f32 logits and the MoE aux metrics."""
        return self._impl.forward(
            self.cfg, params, batch["tokens"], batch.get("frontend_embeds")
        )

    def loss_fn(self, params, batch: dict, *, remat: bool = True):
        """``(loss, metrics)``: next-token cross-entropy (+ the MoE aux
        terms), differentiable in the parameters that ``trainable``
        marked; ``remat`` recomputes each layer in the backward pass (the
        reference's per-period ``jax.checkpoint``)."""
        return self._impl.loss_fn(self.cfg, params, batch, remat=remat)

    def prefill(self, params, batch: dict, max_seq: int | None = None):
        return self._impl.prefill(
            self.cfg, params, batch["tokens"], batch.get("frontend_embeds"),
            max_seq=max_seq,
        )

    def decode_logits(self, params, cache, tokens):
        return self._impl.decode_logits(self.cfg, params, cache, tokens)

    def decode_step(self, params, cache, tokens):
        return self._impl.decode_step(self.cfg, params, cache, tokens)

    def init_cache(self, batch: int, max_seq: int, device="cuda"):
        return self._impl.init_cache(self.cfg, batch, max_seq, resolve_device(device))

    # ---- dry-run specs ---------------------------------------------------
    def input_specs(self, shape: ShapeConfig) -> dict[str, torch.Tensor]:
        """``meta`` stand-ins for every model input of ``shape``: tokens
        int32 (a vit model's image tokens are part of the sequence budget)
        and f32 ``frontend_embeds`` where the arch takes them; one token a
        row to decode."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        meta = torch.device("meta")
        if shape.kind == "decode":
            return {"tokens": torch.empty((b, 1), dtype=torch.int32, device=meta)}
        if shape.kind not in ("train", "prefill"):
            raise ValueError(shape.kind)
        text = s - cfg.n_frontend_tokens if cfg.frontend == "vit" else s
        specs = {"tokens": torch.empty((b, text), dtype=torch.int32, device=meta)}
        if cfg.frontend != "none":
            specs["frontend_embeds"] = torch.empty(
                (b, cfg.n_frontend_tokens, cfg.d_frontend or cfg.d_model),
                dtype=torch.float32, device=meta)
        return specs

    def params_spec(self) -> dict[str, torch.Tensor]:
        """name -> ``meta`` tensor of every parameter."""
        return dict(self.empty_params("meta").named_parameters())

    def empty_params(self, device) -> nn.Module:
        """The parameter module, unfilled, on ``device`` (``meta``: nothing
        allocated; under a ``FakeTensorMode``, fake tensors)."""
        cls = encdec.EncDec if self.cfg.enc_dec else transformer.Transformer
        return cls(self.cfg, device=torch.device(device))

    def cache_spec(self, shape: ShapeConfig):
        """The decode cache of ``shape`` (global batch x its sequence) on
        the ``meta`` device."""
        return self._impl.init_cache(self.cfg, shape.global_batch, shape.seq_len,
                                     torch.device("meta"))


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
