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


def live_cache_specs(cfg: ModelConfig, ctx: ShardCtx, cache):
    """:func:`make_cache_specs` as the live serving path places a cache over
    a data row's ``ctx.tp`` model shards (``lm.init_cache(mesh=...)`` places
    each leaf from these): the same placements but for the one exception, a
    window ring split by its slots (kv heads that do not divide ``tp``),
    which stays whole on the row's first device: the reference attends a
    ring densely, so a ring split by slots would be gathered every step.
    → (the specs, the paths of the leaves the exception keeps whole)."""
    specs = make_cache_specs(cfg, ctx, cache)
    whole = []
    for part in ("groups", "extra"):
        for key, node in specs.get(part, {}).items():
            btype = key.split("_", 1)[1]
            if btype not in ("attn", "local_attn"):
                continue
            window = cfg.window if btype == "attn" else cfg.local_window
            ring = bool(window) and cache[part][key].k.shape[-2] == window
            if not (ring and node.k[-2] == ctx.model_axis):
                continue
            whole += [(part, key, name) for name in ("k", "v")]
            specs[part][key] = dataclasses.replace(node, **{
                name: tuple(None if a == ctx.model_axis else a for a in getattr(node, name))
                for name in ("k", "v")})
    return specs, whole


def split_dims(cfg: ModelConfig, tp: int, cache):
    """The cache tree with each leaf replaced by the dimension of it (the
    stack dimension of a group's leaves not counted) that lies over a data
    row's ``tp`` model shards in the live path (:func:`live_cache_specs`),
    or None where the leaf lies whole on the row's first device (every leaf
    at one shard)."""
    specs, _ = live_cache_specs(cfg, ShardCtx(tp=tp), cache)
    axis = ShardCtx(tp=tp).model_axis

    def walk(node, stacked: bool):
        if isinstance(node, dict):
            return {k: walk(v, stacked or k == "groups") for k, v in node.items()}
        return dataclasses.replace(node, **{
            f.name: (getattr(node, f.name).index(axis) - stacked
                     if tp > 1 and axis in getattr(node, f.name) else None)
            for f in dataclasses.fields(node)})

    return walk(specs, False)


def block_split_dims(cfg: ModelConfig, tp: int, batch: int, capacity: int):
    """{block type: :func:`split_dims` of its cache} for ``batch`` sequences
    and ``capacity`` slots."""
    dims = split_dims(cfg, tp, init_cache(cfg, batch, capacity, device="meta"))
    return {key.split("_", 1)[1]: node for part in dims.values() for key, node in part.items()}


def cache_shard_bytes(cfg: ModelConfig, tp: int, batch: int, capacity: int):
    """The bytes each of ``tp`` model shards of a data row holds of the
    serving caches of ``batch`` sequences and ``capacity`` slots, reckoned
    from :func:`live_cache_specs`: a leaf whose placement names the model
    axis a ``tp``-th on every shard, any other on shard 0."""
    ctx = ShardCtx(tp=tp)
    cache = init_cache(cfg, batch, capacity, device="meta")
    specs, _ = live_cache_specs(cfg, ctx, cache)
    out = [0] * tp
    for (path, leaf), (_, spec) in zip(cache_leaves(cache), cache_leaves(specs)):
        nbytes = leaf.numel() * leaf.element_size()
        if ctx.model_axis in spec:
            out = [b + nbytes // tp for b in out]
        else:
            out[0] += nbytes
    return out
