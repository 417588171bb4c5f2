"""Per-layer blocks with per-type caches: (pre-norm residual) attention and
local-attention blocks with their MLP or MoE feed-forward, the SSD block,
and the RG-LRU block with its MLP."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from .base import ShardCtx, tree_index
from .attention import attention_block, attn_spec, init_kv_cache
from .layers import apply_mlp, apply_norm, mlp_spec, norm_spec
from .moe import moe_ffn, moe_spec
from .rglru import init_rglru_cache, rglru_block, rglru_spec
from .ssd import init_ssd_cache, ssd_block, ssd_spec

ATTENTION = ("attn", "local_attn")


def block_spec(btype: str, cfg: ModelConfig, ctx: ShardCtx) -> Dict[str, Any]:
    if btype in ATTENTION:
        spec = {"norm1": norm_spec(cfg), "attn": attn_spec(cfg, ctx), "norm2": norm_spec(cfg)}
        if cfg.moe is not None:
            spec["moe"] = moe_spec(cfg, ctx)
        else:
            spec["mlp"] = mlp_spec(cfg, ctx)
        return spec
    if btype == "ssd":
        return {"norm1": norm_spec(cfg), "ssd": ssd_spec(cfg, ctx)}
    if btype == "rglru":
        return {"norm1": norm_spec(cfg), "rglru": rglru_spec(cfg, ctx), "norm2": norm_spec(cfg),
                "mlp": mlp_spec(cfg, ctx)}
    raise ValueError(f"unknown block type {btype!r}")


def init_block_cache(btype: str, cfg: ModelConfig, batch: int, capacity: int, device):
    if btype in ATTENTION:
        window = cfg.window if btype == "attn" else cfg.local_window
        return init_kv_cache(cfg, batch, capacity, window=window, device=device)
    if btype == "ssd":
        return init_ssd_cache(cfg, batch, device)
    if btype == "rglru":
        return init_rglru_cache(cfg, batch, device)
    raise ValueError(f"unknown block type {btype!r}")


def block_fwd(
    btype: str,
    params,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    ctx: ShardCtx,
    cache=None,
) -> Tuple[torch.Tensor, Any, Dict[str, torch.Tensor]]:
    """One pre-norm residual block → (x, new cache, aux losses)."""
    aux: Dict[str, torch.Tensor] = {}
    if btype in ATTENTION:
        window = cfg.window if btype == "attn" else cfg.local_window
        h, new_cache = attention_block(params["attn"], cfg, apply_norm(params["norm1"], cfg, x),
                                       positions, window=window, cache=cache, ctx=ctx)
        x = x + h
        h2_in = apply_norm(params["norm2"], cfg, x)
        if cfg.moe is not None:
            h2, aux = moe_ffn(params["moe"], cfg, h2_in, ctx)
        else:
            h2 = apply_mlp(params["mlp"], cfg, h2_in)
        return x + h2, new_cache, aux
    if btype == "ssd":
        h, new_cache = ssd_block(params["ssd"], cfg, apply_norm(params["norm1"], cfg, x),
                                 cache=cache)
        return x + h, new_cache, aux
    if btype == "rglru":
        h, new_cache = rglru_block(params["rglru"], cfg, apply_norm(params["norm1"], cfg, x),
                                   cache=cache)
        x = x + h
        return x + apply_mlp(params["mlp"], cfg, apply_norm(params["norm2"], cfg, x)), new_cache, aux
    raise ValueError(f"unknown block type {btype!r}")


class ParamTree(nn.Module):
    """A nested dict of tensors held as a module: its parameter names are
    the tree's paths joined by dots, so the reference's parameter tree maps
    onto the port's one to one.  ``trainable`` parameters require grad."""

    def __init__(self, tree: Dict[str, Any], trainable: bool = False):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v, trainable))
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=trainable))

    def tree(self) -> Dict[str, Any]:
        out = {name: p for name, p in self.named_parameters(recurse=False)}
        out.update({name: m.tree() for name, m in self.named_children()})
        return out


class Block(ParamTree):
    """The parameters of one block type of the pattern, stacked over the
    layers that use it (leading ``n_groups`` dimension when ``stacked``)."""

    def __init__(self, btype: str, cfg: ModelConfig, tree: Dict[str, Any], stacked: bool,
                 trainable: bool = False):
        super().__init__(tree, trainable)
        self.btype, self.cfg, self.stacked = btype, cfg, stacked

    def forward(self, x, positions, ctx: ShardCtx, layer: int = 0, cache=None):
        params = tree_index(self.tree(), layer) if self.stacked else self.tree()
        return block_fwd(self.btype, params, self.cfg, x, positions, ctx, cache=cache)
