"""repro_torch.models — the decoder LM with attention (dense, sliding-window,
local), MoE feed-forward, Mamba-2 (SSD) and RG-LRU blocks."""
from .base import SINGLE, ParamSpec, ShardCtx, init_params, param_count
from .convert import params_from_numpy
from .lm import LM, forward, init_cache, init_model, lm_loss, model_spec

__all__ = [
    "SINGLE", "ShardCtx", "ParamSpec", "init_params", "param_count", "LM",
    "forward", "init_cache", "init_model", "lm_loss", "model_spec", "params_from_numpy",
]
