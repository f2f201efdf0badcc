"""internvl2-26b [vlm] — InternLM2-20B backbone: 48L d6144 48H (GQA kv=8)
d_ff 16384 vocab 92553; InternViT frontend is a STUB (precomputed patch
embeddings, d_vit=3200 -> projector) [arXiv:2404.16821].

Copy of ``src/repro/configs/internvl2_26b.py`` for the PyTorch port.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv=8,
    d_head=128,
    d_ff=16384,
    vocab_raw=92553,
    rope_theta=1_000_000.0,
    frontend="vit",
    n_frontend_tokens=256,  # one image tile
    d_frontend=3200,  # InternViT-6B hidden size
)

SMOKE_CONFIG = ModelConfig(
    name="internvl2-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    d_head=16,
    d_ff=128,
    vocab_raw=97,
    rope_theta=10_000.0,
    frontend="vit",
    n_frontend_tokens=8,
    d_frontend=32,
)
