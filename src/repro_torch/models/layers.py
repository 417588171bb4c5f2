"""Shared model layers an SSD model uses: norms, embeddings and the LM head.

RoPE, the MLPs and qk-norm come with the attention slice of the port.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelConfig
from .base import ShardCtx, matrix_spec, replicated_spec


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ----------------------------------------------------------------- norms ----


def norm_spec(cfg: ModelConfig, d: Optional[int] = None):
    d = d or cfg.d_model
    if cfg.norm_type == "layernorm":
        return {"scale": replicated_spec((d,), "ones"),
                "bias": replicated_spec((d,), "zeros")}
    return {"scale": replicated_spec((d,), "ones")}


def apply_norm(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """RMS or layer norm over the last dim, computed in float32."""
    xf = x.float()
    if cfg.norm_type == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + 1e-5)
        out = out * params["scale"] + params["bias"]
    else:
        ms = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + 1e-6) * params["scale"]
    return out.to(x.dtype)


# ------------------------------------------------------------- embeddings ----


def embed_spec(cfg: ModelConfig, ctx: ShardCtx):
    v = cfg.padded_vocab(ctx.tp)
    d = cfg.d_model
    out = {"tok": matrix_spec(ctx, (cfg.n_codebooks, v, d), init="normal:0.02")}
    if not cfg.tie_embeddings:
        out["head"] = matrix_spec(ctx, (d, cfg.n_codebooks * v), init="normal:0.02")
    return out


def embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S), or (B, K, S) for multi-codebook audio → (B, S, d)."""
    tok = params["tok"].to(compute_dtype(cfg))
    if cfg.n_codebooks > 1:
        out = 0.0
        for kb in range(cfg.n_codebooks):
            out = out + tok[kb][tokens[:, kb]]
        return out
    return tok[0][tokens]


def lm_logits(params, cfg: ModelConfig, x: torch.Tensor, tp: int) -> torch.Tensor:
    """x (B, S, d) → logits (B, S, V_padded), or (B, S, K, V) for multi-codebook."""
    v = cfg.padded_vocab(tp)
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, params["tok"][0].to(x.dtype))
    else:
        logits = x @ params["head"].to(x.dtype)
    if cfg.n_codebooks > 1:
        B, S, _ = logits.shape
        return logits.reshape(B, S, cfg.n_codebooks, v)
    return logits
