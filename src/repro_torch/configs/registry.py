"""Arch registry: ``--arch <id>`` resolution for launchers and tests.

Copy of ``src/repro/configs/registry.py`` for the PyTorch port.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, SHAPES, ShapeConfig, shape_applicable

ARCHS = {
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "qwen2-72b": "repro_torch.configs.qwen2_72b",
    "yi-9b": "repro_torch.configs.yi_9b",
    "qwen3-4b": "repro_torch.configs.qwen3_4b",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v0_1_52b",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
    "whisper-medium": "repro_torch.configs.whisper_medium",
}


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(ARCHS[name])
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def all_cells():
    """Every applicable (arch, shape) dry-run cell + the documented skips."""
    cells, skips = [], []
    for arch in ARCHS:
        cfg = get_config(arch)
        for sname, shape in SHAPES.items():
            ok, why = shape_applicable(cfg, shape)
            (cells if ok else skips).append((arch, sname) if ok else (arch, sname, why))
    return cells, skips
