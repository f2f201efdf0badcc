"""qwen3-4b [dense] — 36L d2560 32H (GQA kv=8) d_ff 9728 vocab 151936,
qk_norm [hf:Qwen/Qwen3-8B family].

Copy of ``src/repro/configs/qwen3_4b.py`` for the PyTorch port.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv=8,
    d_head=128,
    d_ff=9728,
    vocab_raw=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen3-4b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    d_head=16,
    d_ff=128,
    vocab_raw=97,
    qk_norm=True,
    rope_theta=10_000.0,
)
