"""Public model API (port of ``src/repro/models/api.py``): ``build_model(cfg)``
returns a ``Model`` facade with init / loss / prefill / decode.

The dry-run specs (``input_specs``, ``params_spec``, ``cache_spec``) are
not ported yet (ROADMAP Queue 1 item 4e); encoder-decoder models raise
``NotImplementedError`` (item 4c).
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.core.executor import resolve_device
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init_params(self, seed: int = 0, device="cuda") -> transformer.Transformer:
        return transformer.init_params(self.cfg, seed, device)

    def load_params(self, state_dict: dict, device="cuda") -> transformer.Transformer:
        """A ``Transformer`` on ``device`` holding ``state_dict`` (e.g. from
        ``convert.from_jax_params``)."""
        params = transformer.Transformer(self.cfg, device=resolve_device(device))
        params.load_state_dict(state_dict)
        return params

    def loss_fn(self, params, batch: dict):
        return transformer.loss_fn(self.cfg, params, batch)

    def prefill(self, params, batch: dict, max_seq: int | None = None):
        return transformer.prefill(
            self.cfg, params, batch["tokens"], batch.get("frontend_embeds"),
            max_seq=max_seq,
        )

    def decode_step(self, params, cache, tokens):
        return transformer.decode_step(self.cfg, params, cache, tokens)

    def init_cache(self, batch: int, max_seq: int, device="cuda"):
        return transformer.init_cache(self.cfg, batch, max_seq, resolve_device(device))


def build_model(cfg: ModelConfig) -> Model:
    transformer.check_supported(cfg)
    return Model(cfg)
