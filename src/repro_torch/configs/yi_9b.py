"""yi-9b [dense] — 48L d4096 32H (GQA kv=4) d_ff 11008 vocab 64000,
llama-arch [arXiv:2403.04652].

Copy of ``src/repro/configs/yi_9b.py`` for the PyTorch port.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv=4,
    d_head=128,
    d_ff=11008,
    vocab_raw=64000,
    rope_theta=10_000.0,
)

SMOKE_CONFIG = ModelConfig(
    name="yi-9b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    d_head=16,
    d_ff=96,
    vocab_raw=101,
    rope_theta=10_000.0,
)
