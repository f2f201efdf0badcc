"""xlstm-350m [ssm] — 24L d1024 4H, alternating sLSTM/mLSTM blocks,
vocab 50304 [arXiv:2405.04517].

Copy of ``src/repro/configs/xlstm_350m.py`` for the PyTorch port.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv=4,
    d_head=256,
    d_ff=0,  # blocks carry their own projections
    vocab_raw=50304,
    rope_theta=0.0,
)

SMOKE_CONFIG = ModelConfig(
    name="xlstm-smoke",
    family="ssm",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv=4,
    d_head=16,
    d_ff=0,
    vocab_raw=97,
    rope_theta=0.0,
)
