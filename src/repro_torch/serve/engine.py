"""Batched LM serving engine (port of ``src/repro/serve/engine.py``):
prefill to ``max_seq``, then a greedy decode loop through the model
facade (``Model.prefill``, ``Model.decode_logits``), for decoder-only
and encoder-decoder models alike; ``**extras`` (``frontend_embeds``:
image patches, audio frames) go to the prefill.

``generate`` runs under ``torch.inference_mode()``: it records no
autograd graph, also for parameters a trainer marked trained.

The cache (``models.transformer.Cache``) is updated in place, the
counterpart of the reference's ``donate_argnums``: attention K/V tensors
``(B, S_max, K, hd)`` written a token at a time, recurrent states
(mamba, mLSTM, sLSTM) replaced a step at a time.  The engine runs on the
card unless the caller passes ``device="cpu"``; without a card it
raises.

Query serving over *sorted ELSAR output* does not go through this decode
loop — that workload is ``repro_torch.serve.query_engine.QueryEngine``
over a ``repro_torch.serve.index.SortedFileIndex`` (DESIGN.md §7)."""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.executor import resolve_device


@dataclasses.dataclass
class GenerateStats:
    """Host-clock seconds of the last ``generate`` (each ends with the
    tokens copied to the host, so the device work is inside), its decode
    steps, and whether every logit it computed was finite."""

    prefill_seconds: float = 0.0
    decode_seconds: float = 0.0
    decode_steps: int = 0
    logits_finite: bool = True


class ServeEngine:
    def __init__(self, model, params=None, seed: int = 0, device="cuda"):
        self.model = model
        self.device = resolve_device(device)
        self.params = (
            params.to(self.device)
            if params is not None
            else model.init_params(seed, self.device)
        )
        self.stats = GenerateStats()

    @torch.inference_mode()
    def generate(
        self, prompts: np.ndarray, max_new_tokens: int = 16, **extras
    ) -> np.ndarray:
        cfg, dev = self.model.cfg, self.device
        batch = {"tokens": torch.as_tensor(np.asarray(prompts), device=dev), **{
            k: torch.as_tensor(np.asarray(v), device=dev) for k, v in extras.items()
        }}
        # attention caches need headroom for the tokens we will generate
        max_seq = prompts.shape[1] + max_new_tokens + (
            cfg.n_frontend_tokens if cfg.frontend == "vit" else 0
        )
        t0 = time.perf_counter()
        last, cache = self.model.prefill(self.params, batch, max_seq=max_seq)
        finite = torch.isfinite(last).all()
        tok = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
        out = [tok.cpu().numpy()]
        t1 = time.perf_counter()
        for _ in range(max_new_tokens - 1):
            logits = self.model.decode_logits(self.params, cache, tok)
            finite &= torch.isfinite(logits).all()
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            out.append(tok.cpu().numpy())
        self.stats = GenerateStats(
            prefill_seconds=t1 - t0,
            decode_seconds=time.perf_counter() - t1,
            decode_steps=max_new_tokens - 1,
            logits_finite=bool(finite),
        )
        return np.concatenate(out, axis=1)
