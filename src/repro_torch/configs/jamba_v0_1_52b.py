"""jamba-v0.1-52b [hybrid] — 32L d4096 32H (GQA kv=8) Mamba:attn 7:1,
MoE 16e top-2 (every other layer) d_ff 14336 vocab 65536
[arXiv:2403.19887].

Copy of ``src/repro/configs/jamba_v0_1_52b.py`` for the PyTorch port.
"""

from repro_torch.configs.base import MambaConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_head=128,
    d_ff=14336,
    vocab_raw=65536,
    rope_theta=0.0,  # jamba uses no positional encoding in attention
    attn_period=8,  # 1 attention layer per 8 (1:7 interleave)
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336, every=2),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
)

SMOKE_CONFIG = ModelConfig(
    name="jamba-smoke",
    family="hybrid",
    n_layers=8,
    d_model=64,
    n_heads=4,
    n_kv=2,
    d_head=16,
    d_ff=128,
    vocab_raw=97,
    rope_theta=0.0,
    attn_period=8,
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64, every=2),
    mamba=MambaConfig(d_state=4, d_conv=4, expand=2),
)
