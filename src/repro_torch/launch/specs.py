"""Stand-ins for every model input: ``meta`` tensors of the inputs' shapes
and types, and their placements; nothing is allocated (the dry run's
contract).

A placement is a tuple with one entry a dimension: None, the model axis, or
the data axes (``"data"``, or ``("pod", "data")``), as ``ParamSpec.placement``
writes the reference's ``PartitionSpec``.  For ``[vlm]`` archs the modality
frontend is a stub: the inputs include the precomputed patch embeddings.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models.base import ShardCtx
from ..models.lm import init_cache


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig, ctx: ShardCtx
                      ) -> Tuple[Dict[str, torch.Tensor], Dict[str, tuple]]:
    """(the batch's ``meta`` tensors, their placements): tokens and labels
    (B, S), or (B, K, S) over ``K`` codebooks, the batch over the data
    axes; a VLM's ``vis_embeds`` (B, n_vis, d) in bf16."""
    B, S = shape.global_batch, shape.seq_len
    dspec = ctx.data_spec()
    if cfg.n_codebooks > 1:
        tok = _meta((B, cfg.n_codebooks, S), torch.int32)
        tok_spec = (dspec, None, None)
    else:
        tok = _meta((B, S), torch.int32)
        tok_spec = (dspec, None)
    shapes = {"tokens": tok, "labels": tok}
    specs = {"tokens": tok_spec, "labels": tok_spec}
    if cfg.n_vis_tokens:
        shapes["vis_embeds"] = _meta((B, cfg.n_vis_tokens, cfg.d_model), torch.bfloat16)
        specs["vis_embeds"] = (dspec, None, None)
    return shapes, specs


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig, ctx: ShardCtx
                       ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A decode step's inputs: one new token and the cache of ``seq_len``
    slots (``lm.init_cache`` on ``meta``), and their placements."""
    B, S = shape.global_batch, shape.seq_len
    # batch 1 (long_500k) cannot be split over the data axes: replicated
    shardable = B % ctx.dp_total == 0
    dspec = ctx.data_spec() if shardable else None
    if cfg.n_codebooks > 1:
        tok = _meta((B, cfg.n_codebooks, 1), torch.int32)
        tok_spec = (dspec, None, None)
    else:
        tok = _meta((B, 1), torch.int32)
        tok_spec = (dspec, None)
    cache = init_cache(cfg, B, S, device="meta")
    shapes = {"tokens": tok, "cache": cache, "pos": _meta((), torch.int32)}
    specs = {"tokens": tok_spec, "cache": make_cache_specs(cfg, ctx, cache, shardable),
             "pos": ()}
    return shapes, specs


def cache_leaves(cache, prefix: Tuple[str, ...] = ()):
    """[(path, tensor)] of a cache tree: dict keys, then a cache's field
    names, in order."""
    if isinstance(cache, dict):
        return [leaf for k, v in cache.items() for leaf in cache_leaves(v, prefix + (k,))]
    return [(prefix + (f.name,), getattr(cache, f.name)) for f in dataclasses.fields(cache)]


def make_cache_specs(cfg: ModelConfig, ctx: ShardCtx, cache, batch_shardable: bool = True):
    """The placement of every cache leaf, by its field name: the cache tree
    with each tensor replaced by its placement tuple.

    KV ``k`` / ``v`` (B, Hkv, C, D): batch over the data axes; kv-heads over
    the model axis when they divide it, else the slots C (split-S decode).
    SSD ``h`` (B, H, N, P): heads over the model axis.  RG-LRU ``h`` (B, W)
    and a conv tail ``conv`` (B, W-1, C): the width over the model axis when
    it divides.  Leaves under ``groups`` carry a leading stack dimension,
    replicated."""
    dspec = ctx.data_spec() if batch_shardable else None

    def leaf_spec(stacked: bool, field: str, leaf: torch.Tensor) -> tuple:
        core = list(leaf.shape[1:] if stacked else leaf.shape)
        if not core:  # pos
            return (None,) if stacked else ()
        axes: list = [None] * len(core)
        if field in ("k", "v") and len(core) == 4:
            axes[0] = dspec
            if core[1] % ctx.tp == 0 and core[1] >= ctx.tp:
                axes[1] = ctx.model_axis  # kv-heads
            elif core[2] % ctx.tp == 0:
                axes[2] = ctx.model_axis  # split-S
        elif field == "h" and len(core) in (2, 4):  # RG-LRU (B, W); SSD (B, H, N, P)
            axes[0] = dspec
            if core[1] % ctx.tp == 0:
                axes[1] = ctx.model_axis
        elif field == "conv" and len(core) == 3:
            axes[0] = dspec
            if core[2] % ctx.tp == 0:
                axes[2] = ctx.model_axis
        else:
            axes[0] = dspec if core[0] else None
        return tuple([None] + axes if stacked else axes)

    def walk(node, stacked: bool):
        if isinstance(node, dict):
            return {k: walk(v, stacked or k == "groups") for k, v in node.items()}
        return dataclasses.replace(node, **{
            f.name: leaf_spec(stacked, f.name, getattr(node, f.name))
            for f in dataclasses.fields(node)})

    return walk(cache, False)
