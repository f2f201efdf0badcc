"""mixtral-8x7b [moe] — 32L d4096 32H (GQA kv=8) MoE 8e top-2 d_ff 14336
vocab 32000, sliding window 4096 [arXiv:2401.04088].

Copy of ``src/repro/configs/mixtral_8x7b.py`` for the PyTorch port.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_head=128,
    d_ff=14336,
    vocab_raw=32000,
    window=4096,
    rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=14336, capacity_factor=1.25),
)

SMOKE_CONFIG = ModelConfig(
    name="mixtral-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    d_head=16,
    d_ff=128,
    vocab_raw=97,
    window=16,
    rope_theta=10_000.0,
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64),
)
