"""The decoder LM: embeds → the block-pattern groups → final norm → head.

Parameters keep the reference's tree (``embed``, ``final_norm``,
``groups/p<i>_<type>`` stacked along a leading ``n_groups`` dim, ``extra``
for remainder layers), held by the :class:`LM` module.  The reference scans
over the groups; here the layers are a loop over them, each group
optionally rematerialised in the backward (``remat``).  Caches are stacked
the same way.  :func:`lm_loss` is the training loss.
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..kernels import ops as kops
from .attention import KVCache
from .base import SINGLE, ShardCtx, init_params, resolve_device, stack_tree, tree_map
from .blocks import Block, ParamTree, block_spec, init_block_cache
from .layers import apply_norm, compute_dtype, embed_spec, embed_tokens, lm_logits, norm_spec
from .ssd import SSDCache

_CACHES = (SSDCache, KVCache)

# ------------------------------------------------------------------ params --


def model_spec(cfg: ModelConfig, ctx: ShardCtx = SINGLE) -> Dict[str, Any]:
    n_groups, n_extra = cfg.pattern_groups
    pattern = cfg.block_pattern
    spec: Dict[str, Any] = {"embed": embed_spec(cfg, ctx), "final_norm": norm_spec(cfg)}
    if n_groups > 0:
        spec["groups"] = {
            f"p{i}_{btype}": stack_tree(block_spec(btype, cfg, ctx), n_groups)
            for i, btype in enumerate(pattern)
        }
    if n_extra:
        spec["extra"] = {
            f"x{i}_{pattern[i % len(pattern)]}": block_spec(pattern[i % len(pattern)], cfg, ctx)
            for i in range(n_extra)
        }
    return spec


class LM(nn.Module):
    """The model's parameters as modules; ``forward`` runs :func:`forward`.
    ``trainable``: the parameters require grad (the training storage)."""

    def __init__(self, cfg: ModelConfig, tree: Dict[str, Any], ctx: ShardCtx = SINGLE,
                 trainable: bool = False):
        super().__init__()
        self.cfg, self.ctx = cfg, ctx
        pattern = cfg.block_pattern
        self.embed = ParamTree(tree["embed"], trainable)
        self.final_norm = ParamTree(tree["final_norm"], trainable)
        self.groups = nn.ModuleDict({
            key: Block(pattern[i], cfg, sub, stacked=True, trainable=trainable)
            for i, (key, sub) in enumerate(tree.get("groups", {}).items())
        })
        self.extra = nn.ModuleDict({
            key: Block(pattern[i % len(pattern)], cfg, sub, stacked=False, trainable=trainable)
            for i, (key, sub) in enumerate(tree.get("extra", {}).items())
        })

    def tree(self) -> Dict[str, Any]:
        """The parameters as the reference's tree of tensors."""
        out = {"embed": self.embed.tree(), "final_norm": self.final_norm.tree()}
        if len(self.groups):
            out["groups"] = {key: block.tree() for key, block in self.groups.items()}
        if len(self.extra):
            out["extra"] = {key: block.tree() for key, block in self.extra.items()}
        return out

    @property
    def device(self) -> torch.device:
        return self.embed.tok.device

    def forward(self, tokens, cache=None, start_pos=None, remat: bool = False,
                vis_embeds=None):
        return forward(self, self.cfg, tokens, self.ctx, cache=cache, start_pos=start_pos,
                       remat=remat, vis_embeds=vis_embeds)


def init_model(cfg: ModelConfig, ctx: ShardCtx = SINGLE, seed: int = 0, device=None,
               trainable: bool = False) -> LM:
    """Random weights from a ``torch.Generator`` seeded with ``seed``, made
    on ``device`` (the card unless asked).  Serving: each in the type it is
    used in.  ``trainable``: every leaf float32 and requiring grad, cast to
    the compute type at use (the reference's master weights)."""
    dev = resolve_device(device)
    tree = init_params(model_spec(cfg, ctx), seed, compute_dtype(cfg), dev, master=trainable)
    return LM(cfg, tree, ctx, trainable=trainable)


# ------------------------------------------------------------------- cache --


def _stack(caches):
    first = caches[0]
    if isinstance(first, _CACHES):
        return type(first)(*(torch.stack(ts) for ts in zip(*(c.tensors() for c in caches))))
    raise TypeError(f"no stacking rule for {type(first).__name__}")


def _index(cache, i: int):
    if isinstance(cache, _CACHES):
        return type(cache)(*(t[i] for t in cache.tensors()))
    raise TypeError(f"no indexing rule for {type(cache).__name__}")


def init_cache(cfg: ModelConfig, batch: int, capacity: int, device=None):
    """Per-layer caches, stacked like the parameters."""
    dev = resolve_device(device)
    n_groups, n_extra = cfg.pattern_groups
    pattern = cfg.block_pattern
    cache: Dict[str, Any] = {}
    if n_groups > 0:
        cache["groups"] = {
            f"p{i}_{btype}": _stack([init_block_cache(btype, cfg, batch, capacity, dev)] * n_groups)
            for i, btype in enumerate(pattern)
        }
    if n_extra:
        cache["extra"] = {
            f"x{i}_{pattern[i % len(pattern)]}": init_block_cache(
                pattern[i % len(pattern)], cfg, batch, capacity, dev)
            for i in range(n_extra)
        }
    return cache


def cache_tensors(cache):
    """Every tensor of a stacked cache tree."""
    out = []
    tree_map(lambda c: out.extend(c.tensors()), cache)
    return out


# ----------------------------------------------------------------- forward --


def forward(
    params: LM,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # (B, S) or (B, K, S) for multi-codebook
    ctx: ShardCtx = SINGLE,
    cache=None,
    start_pos: Optional[torch.Tensor] = None,
    remat: bool = False,
    vis_embeds: Optional[torch.Tensor] = None,  # (B, n_vis, d) VLM stub input
) -> Tuple[torch.Tensor, Any, Dict[str, torch.Tensor]]:
    """Returns (logits, new_cache, aux_losses).  ``remat`` (without a cache)
    recomputes each group's activations in the backward
    (``torch.utils.checkpoint``, non-reentrant).  A VLM config
    (``cfg.n_vis_tokens``) given ``vis_embeds`` prepends them to the token
    embeddings; positions run over the whole sequence and the logits cover
    the text positions only, as in the reference."""
    dt = compute_dtype(cfg)
    x = embed_tokens(params.embed.tree(), cfg, tokens).to(dt)
    vis = cfg.n_vis_tokens and vis_embeds is not None
    if vis:
        x = torch.cat([vis_embeds.to(device=x.device, dtype=dt), x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    if start_pos is not None:
        positions = start_pos + positions

    n_groups, n_extra = cfg.pattern_groups
    new_cache: Optional[Dict[str, Any]] = None if cache is None else {}
    aux_total: Dict[str, torch.Tensor] = {}

    def merge(aux):
        for k, v in aux.items():
            aux_total[k] = aux_total.get(k, 0.0) + v

    if n_groups > 0:
        outs: Dict[str, list] = {key: [] for key in params.groups}

        def group_body(x, g):
            auxes = []
            for key, block in params.groups.items():
                c_in = None if cache is None else _index(cache["groups"][key], g)
                x, c_out, aux = block(x, positions, ctx, layer=g, cache=c_in)
                auxes.append(aux)
                if c_out is not None:
                    outs[key].append(c_out)
            return x, auxes

        backend = kops.backend()  # the recompute runs on autograd's thread

        def contexts():
            return nullcontext(), kops.local_backend(backend)

        for g in range(n_groups):
            if remat and cache is None:
                # the reference's jax.checkpoint around the group body: its
                # activations are recomputed in the backward, on the same
                # kernel backend as the forward
                x, auxes = checkpoint(group_body, x, g, use_reentrant=False,
                                      context_fn=contexts)
            else:
                x, auxes = group_body(x, g)
            for aux in auxes:
                merge(aux)
        if new_cache is not None:
            new_cache["groups"] = {key: _stack(cs) for key, cs in outs.items()}
    if n_extra:
        extra: Dict[str, Any] = {}
        for key, block in params.extra.items():
            c_in = None if cache is None else cache["extra"][key]
            x, c_out, aux = block(x, positions, ctx, cache=c_in)
            merge(aux)
            if c_out is not None:
                extra[key] = c_out
        if new_cache is not None:
            new_cache["extra"] = extra

    x = apply_norm(params.final_norm.tree(), cfg, x)
    if vis:
        x = x[:, vis_embeds.shape[1]:]  # logits over text positions only
    logits = lm_logits(params.embed.tree(), cfg, x, ctx.tp)
    return logits, new_cache, aux_total


# -------------------------------------------------------------------- loss --


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, vocab: int) -> torch.Tensor:
    """Mean next-token cross-entropy in float32 over labels != -100.
    logits (B, S, V) or (B, S, K, V); labels (B, S) or (B, K, S).  The
    padded vocab tail is masked out of the softmax; the gold logit is
    gathered (the reference's masked sum selects the same value)."""
    lf = logits.float()
    if lf.shape[-1] > vocab:
        pad = torch.arange(lf.shape[-1], device=lf.device) >= vocab
        lf = lf.masked_fill(pad, -1e30)
    if logits.dim() == 4:  # multi-codebook: (B, S, K, V) against labels (B, K, S)
        lf = lf.permute(0, 2, 1, 3)
    mask = labels != -100
    safe = torch.where(mask, labels, 0).long()
    logz = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / mask.sum().clamp(min=1)
