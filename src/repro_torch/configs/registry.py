"""Architecture registry: ``--arch <id>`` resolution.

One module per assigned architecture under ``repro/configs/``; each exports
``CONFIG``.  All configs are from public literature (source tags inline).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from .base import ModelConfig, ShapeConfig, SHAPES, smoke_variant

ARCH_IDS: List[str] = [
    "qwen3_moe_30b_a3b",
    "granite_moe_3b_a800m",
    "qwen3_8b",
    "starcoder2_7b",
    "smollm_360m",
    "h2o_danube_3_4b",
    "internvl2_76b",
    "recurrentgemma_9b",
    "mamba2_2p7b",
    "musicgen_large",
]

# dashed aliases matching the assignment sheet
ALIASES: Dict[str, str] = {
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "qwen3-8b": "qwen3_8b",
    "starcoder2-7b": "starcoder2_7b",
    "smollm-360m": "smollm_360m",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "internvl2-76b": "internvl2_76b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "mamba2-2.7b": "mamba2_2p7b",
    "musicgen-large": "musicgen_large",
}


def get_config(arch: str) -> ModelConfig:
    arch = ALIASES.get(arch, arch).replace("-", "_").replace(".", "p")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return smoke_variant(get_config(arch))


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def all_cells() -> List[tuple]:
    """All (arch, shape) dry-run cells, with long_500k restricted to
    sub-quadratic families (skips recorded in DESIGN.md §4)."""
    cells = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            if shape.name == "long_500k" and not cfg.sub_quadratic:
                continue
            cells.append((arch, shape.name))
    return cells
