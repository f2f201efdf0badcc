"""Model/shape config schema + the assigned input-shape registry.

Copy of ``src/repro/configs/base.py`` for the PyTorch port.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    every: int = 1  # MoE FFN on layers with (idx % every == every - 1)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | vlm | ssm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_head: int
    d_ff: int
    vocab_raw: int
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    window: int = 0  # sliding-window size, 0 = full attention
    norm_eps: float = 1e-5
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    attn_period: int = 1  # jamba: 1 attention layer per `attn_period` layers
    # frontends / structure
    frontend: str = "none"  # none | vit | audio
    enc_dec: bool = False
    n_enc_layers: int = 0
    # frontend stub dims
    n_frontend_tokens: int = 0  # image patches / audio frames
    d_frontend: int = 0
    # training
    tie_embeddings: bool = False

    @property
    def vocab(self) -> int:
        """Vocab padded to a multiple of 32 for clean TP sharding."""
        return (self.vocab_raw + 31) // 32 * 32

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid / sliding-window)."""
        return self.family in ("ssm", "hybrid") or self.window > 0

    def layer_plan(self) -> list[tuple[int, tuple[str, ...]]]:
        """Scan-group plan: list of (n_repeat, period_sublayers).

        Sublayer kinds: attn / attn_swa / mlp / moe / mamba / mlstm / slstm.
        A "period" is the repeating unit; params are stacked over n_repeat
        and the forward scans over them (homogeneous periods => small HLO).
        """
        ffn = "moe" if (self.moe and self.moe.every == 1) else "mlp"
        attn = "attn_swa" if self.window > 0 else "attn"
        if self.family in ("dense", "vlm"):
            return [(self.n_layers, (attn, "mlp"))]
        if self.family == "moe" and self.name.startswith("moonshot"):
            # DeepSeek/Moonlight-style: first layer dense, rest MoE
            return [
                (1, (attn, "mlp")),
                (self.n_layers - 1, (attn, "moe")),
            ]
        if self.family == "moe":
            return [(self.n_layers, (attn, ffn))]
        if self.family == "hybrid":
            # jamba: period of attn_period layers, attention first, mamba
            # rest; MoE on odd global layers (every=2)
            period: list[str] = []
            for i in range(self.attn_period):
                period.append("attn" if i == 0 else "mamba")
                period.append("moe" if i % 2 == 1 else "mlp")
            return [(self.n_layers // self.attn_period, tuple(period))]
        if self.family == "ssm":
            return [(self.n_layers // 2, ("mlstm", "slstm"))]
        if self.family == "audio":
            # decoder plan (encoder plan is built by encdec.py)
            return [(self.n_layers, ("attn", "cross", "mlp"))]
        raise ValueError(self.family)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int
    microbatches: int = 1  # grad-accum steps (train only)


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: long_500k skipped (DESIGN.md)"
    return True, ""
