"""repro_torch.models — the decoder LM, so far with the Mamba-2 (SSD) block."""
from .base import SINGLE, ParamSpec, ShardCtx, init_params, param_count
from .convert import params_from_numpy
from .lm import LM, forward, init_cache, init_model, model_spec

__all__ = [
    "SINGLE", "ShardCtx", "ParamSpec", "init_params", "param_count", "LM",
    "forward", "init_cache", "init_model", "model_spec", "params_from_numpy",
]
