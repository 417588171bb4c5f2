"""repro.configs — assigned-architecture configurations (--arch ids)."""
from .base import ModelConfig, MoEConfig, RGLRUConfig, RunConfig, SSDConfig, ShapeConfig, SHAPES, smoke_variant
from .registry import ALIASES, ARCH_IDS, all_cells, get_config, get_shape, get_smoke_config

__all__ = [
    "ModelConfig", "MoEConfig", "SSDConfig", "RGLRUConfig", "RunConfig",
    "ShapeConfig", "SHAPES", "smoke_variant", "ARCH_IDS", "ALIASES",
    "get_config", "get_shape", "get_smoke_config", "all_cells",
]
