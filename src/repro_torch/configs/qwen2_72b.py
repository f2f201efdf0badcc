"""qwen2-72b [dense] — 80L d8192 64H (GQA kv=8) d_ff 29568 vocab 152064,
QKV bias [arXiv:2407.10671].

Copy of ``src/repro/configs/qwen2_72b.py`` for the PyTorch port.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    d_head=128,
    d_ff=29568,
    vocab_raw=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen2-72b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    d_head=16,
    d_ff=128,
    vocab_raw=97,
    qkv_bias=True,
    rope_theta=10_000.0,
)
