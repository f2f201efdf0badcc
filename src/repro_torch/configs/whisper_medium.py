"""whisper-medium [audio] — 24L enc + 24L dec, d1024 16H (MHA kv=16)
d_ff 4096 vocab 51865; conv/mel frontend is a STUB (precomputed frame
embeddings, 1500 frames) [arXiv:2212.04356].

Copy of ``src/repro/configs/whisper_medium.py`` for the PyTorch port.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv=16,
    d_head=64,
    d_ff=4096,
    vocab_raw=51865,
    rope_theta=10_000.0,  # decoder self-attn RoPE (backbone exercise;
    # the official model uses learned abs-pos, noted in DESIGN.md)
    enc_dec=True,
    n_enc_layers=24,
    frontend="audio",
    n_frontend_tokens=1500,
    d_frontend=1024,
)

SMOKE_CONFIG = ModelConfig(
    name="whisper-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=4,
    d_head=16,
    d_ff=128,
    vocab_raw=97,
    rope_theta=10_000.0,
    enc_dec=True,
    n_enc_layers=2,
    frontend="audio",
    n_frontend_tokens=16,
    d_frontend=64,
)
