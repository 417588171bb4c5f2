"""Serving steps: prefill + batched decode.

``make_serve_fns`` builds the (prefill, decode) pair used by the serving
session (:mod:`repro_torch.serve.session`); ``greedy_generate`` is the
host-driven greedy loop over them.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..models.base import ShardCtx
from ..models.lm import forward, init_cache


def make_serve_fns(cfg: ModelConfig, ctx: ShardCtx, mesh=None, capacity: int = 2048,
                   use_ep: bool = False):
    """Returns (prefill_fn, decode_fn, new_cache_fn), on the model's device,
    or over ``mesh`` (a ``launch.mesh.ModelMesh``: the logits on its first
    device; ``use_ep`` runs the MoE layers expert-parallel).

    prefill_fn(params, tokens)            -> (last_logits, cache)
    decode_fn(params, cache, tokens, pos) -> (last_logits, cache)
    """

    def new_cache(batch, device=None):
        return init_cache(cfg, batch, capacity, device, mesh=mesh, use_ep=use_ep)

    @torch.no_grad()
    def prefill(params, tokens):
        dev = params.device if mesh is None else mesh.first
        cache = new_cache(tokens.shape[0], dev)
        start = torch.zeros((), dtype=torch.int32, device=dev)
        logits, cache, _ = forward(params, cfg, tokens, ctx, mesh=mesh, cache=cache,
                                   start_pos=start, use_ep=use_ep)
        return logits[:, -1], cache

    @torch.no_grad()
    def decode(params, cache, tokens, pos):
        logits, cache, _ = forward(params, cfg, tokens, ctx, mesh=mesh, cache=cache,
                                   start_pos=pos, use_ep=use_ep)
        return logits[:, -1], cache

    return prefill, decode, new_cache


def greedy_generate(cfg: ModelConfig, params, prefill_fn, decode_fn,
                    prompt: torch.Tensor, n_tokens: int) -> torch.Tensor:
    """Greedy decoding (host-driven: the session layer preempts between
    steps, each decode step one preemption quantum).  ``prompt`` (B, S0) or
    (B, K, S0) → tokens (B, n_tokens) or (B, K, n_tokens)."""
    logits, cache = prefill_fn(params, prompt)
    s0 = prompt.shape[-1]
    outs = []
    multi = cfg.n_codebooks > 1
    for t in range(n_tokens):
        nxt = logits[..., : cfg.vocab].argmax(-1).to(torch.int32)
        outs.append(nxt)
        step = nxt[:, :, None] if multi else nxt[:, None]
        pos = torch.tensor(s0 + t, dtype=torch.int32, device=prompt.device)
        logits, cache = decode_fn(params, cache, step, pos)
    return torch.stack(outs, dim=-1)
