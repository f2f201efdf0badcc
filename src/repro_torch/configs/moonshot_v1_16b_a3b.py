"""moonshot-v1-16b-a3b [moe] — 48L d2048 16H (kv=16) MoE 64e top-6
d_ff_expert 1408 vocab 163840 + 2 shared experts, first layer dense
[hf:moonshotai/Moonlight-16B-A3B].

Copy of ``src/repro/configs/moonshot_v1_16b_a3b.py`` for the PyTorch port.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    d_head=128,
    d_ff=11264,  # dense first layer (DeepSeek-style)
    vocab_raw=163840,
    rope_theta=50_000.0,
    moe=MoEConfig(
        n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2, capacity_factor=1.25
    ),
)

SMOKE_CONFIG = ModelConfig(
    name="moonshot-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=4,
    d_head=16,
    d_ff=96,
    vocab_raw=97,
    rope_theta=10_000.0,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, n_shared=1),
)
