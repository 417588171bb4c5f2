"""Shared model layers: norms, qk-norm, RoPE, MLPs, embeddings and the LM
head.  A weight given as a tuple of tensors is held in slices over a data
row's model shards (``models/tp.py``): the MLP runs column-parallel gate and
up and a row-parallel down, the embedding vocab-parallel, the head by column
slices; :func:`column_product` and :func:`row_product` are the SSD and
RG-LRU projections' two halves.  An activation held in sequence slices over
the shards (``tp.SeqSlices``, the reference's sequence parallelism) is
normed where its slices lie, gathered whole onto every shard before a
column-parallel product and reduce-scattered after a row-parallel one."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from . import tp as TP
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


def apply_norm(params, cfg: ModelConfig, x):
    """RMS or layer norm over the last dim, computed in float32; on
    sequence slices, each slice where it lies, the scales sent to the
    shards by ``tp.broadcast`` (their gradients add in shard order)."""
    if isinstance(x, TP.SeqSlices):
        sent = {k: TP.broadcast(v, x.devices) for k, v in params.items()}
        return TP.SeqSlices([apply_norm({k: v[s] for k, v in sent.items()}, cfg, p)
                             for s, p in enumerate(x.parts)])
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


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """qk-norm: RMS over the head dim (Qwen3 style)."""
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + 1e-6) * scale).to(x.dtype)


# ------------------------------------------------------------------ RoPE ----


def rope_freqs(cfg: ModelConfig, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) → (cos, sin) of shape (..., S, head_dim / 2), f32."""
    half = cfg.head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    inv = 1.0 / (cfg.rope_theta ** exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, H, S, D); cos / sin (B, S, D / 2): the rotate-half convention."""
    d = x.shape[-1]
    half = d // 2
    x1, x2 = x[..., :half], x[..., half:2 * half]
    c, s = cos[:, None], sin[:, None]
    r1 = x1 * c - x2 * s
    r2 = x2 * c + x1 * s
    if 2 * half == d:
        return torch.cat([r1, r2], -1).to(x.dtype)
    return torch.cat([r1, r2, x[..., 2 * half:].float()], -1).to(x.dtype)


# ------------------------------------------------------ sliced products ----


def column_product(x, w) -> torch.Tensor:
    """``x @ w`` in x's type, whole on x's (first) device; ``w`` held in
    column slices over the shards (a tuple): x sent whole to each shard
    (``tp.spread``), each shard's columns on its device, joined on x's
    device."""
    if not isinstance(w, tuple):
        return x @ w.to(x.dtype)
    xs = TP.spread(x, [t.device for t in w])
    return TP.join([a @ t.to(x.dtype) for a, t in zip(xs, w)], -1, x.device)


def row_product(y: torch.Tensor, w, like=None):
    """``y @ w`` in y's type; ``w`` held in row slices over the shards (a
    tuple): y's matching columns scattered to the shards, the partial
    products added in shard order (``tp.collect``), on y's device or, where
    ``like`` is in sequence slices, into its slices."""
    if not isinstance(w, tuple):
        return y @ w.to(y.dtype)
    ys = TP.scatter(y.chunk(len(w), dim=-1), [t.device for t in w])
    return TP.collect([a @ t.to(y.dtype) for a, t in zip(ys, w)], y if like is None else like)


# ------------------------------------------------------------------- MLP ----


def mlp_spec(cfg: ModelConfig, ctx: ShardCtx):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_type in ("swiglu", "geglu"):
        return {"w_gate": matrix_spec(ctx, (d, f), tp_dim=1, fsdp_dim=0),
                "w_up": matrix_spec(ctx, (d, f), tp_dim=1, fsdp_dim=0),
                "w_down": matrix_spec(ctx, (f, d), tp_dim=0, fsdp_dim=1)}
    return {"w_up": matrix_spec(ctx, (d, f), tp_dim=1, fsdp_dim=0),
            "w_down": matrix_spec(ctx, (f, d), tp_dim=0, fsdp_dim=1)}


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def apply_mlp(params, cfg: ModelConfig, x):
    if isinstance(params["w_up"], tuple):
        # each shard's gate and up columns and its rows of down, on its
        # device; the parts add on x's device, or into x's sequence slices
        devs = [w.device for w in params["w_up"]]
        parts = [apply_mlp({k: w[s] for k, w in params.items()}, cfg, xs)
                 for s, xs in enumerate(TP.spread(x, devs))]
        return TP.collect(parts, x)
    dt = x.dtype
    if cfg.mlp_type in ("swiglu", "geglu"):
        act = F.silu if cfg.mlp_type == "swiglu" else _gelu
        g = x @ params["w_gate"].to(dt)
        u = x @ params["w_up"].to(dt)
        h = act(g.float()).to(dt) * u
    else:
        u = x @ params["w_up"].to(dt)
        h = _gelu(u.float()).to(dt)
    return h @ params["w_down"].to(dt)


# ------------------------------------------------------------- embeddings ----


def embed_spec(cfg: ModelConfig, ctx: ShardCtx):
    v = cfg.padded_vocab(ctx.tp)
    d = cfg.d_model
    out = {"tok": matrix_spec(ctx, (cfg.n_codebooks, v, d), tp_dim=1, fsdp_dim=2,
                              init="normal:0.02")}
    if not cfg.tie_embeddings:
        out["head"] = matrix_spec(ctx, (d, cfg.n_codebooks * v), tp_dim=1, fsdp_dim=0,
                                  init="normal:0.02")
    return out


def embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor, seq: bool = False):
    """tokens (B, S), or (B, K, S) for multi-codebook audio → (B, S, d);
    ``seq`` (a table in vocabulary slices): in sequence slices over the
    shards that hold them (``tp.SeqSlices``)."""
    if isinstance(params["tok"], tuple):
        rows = _embed_vocab_parallel(params["tok"], cfg, tokens, seq)
        if seq:
            return TP.SeqSlices([_add_codebooks(cfg, list(r)) for r in rows])
    else:
        tok = params["tok"].to(compute_dtype(cfg))
        rows = [tok[kb][tokens[:, kb] if cfg.n_codebooks > 1 else tokens]
                for kb in range(cfg.n_codebooks)]
    return _add_codebooks(cfg, rows)


def _add_codebooks(cfg: ModelConfig, rows):
    if cfg.n_codebooks > 1:
        out = 0.0
        for r in rows:
            out = out + r
        return out
    return rows[0]


def _embed_vocab_parallel(tok, cfg: ModelConfig, tokens: torch.Tensor, seq: bool = False):
    """Each codebook's rows looked up in a table held in vocabulary slices
    over the shards: shard ``s`` looks up the ids in its range, zeros
    elsewhere, and the parts add on the tokens' device in shard order (or,
    ``seq``, each shard's tokens on its own device: ``tp.reduce_scatter_seq``
    → each shard's (K, B, S / n, d)).  One part is non-zero at each
    position, so each codebook's rows equal the whole lookup's bit for
    bit."""
    dt = compute_dtype(cfg)
    n = tok[0].shape[1]
    parts = []
    for s, ids in enumerate(TP.broadcast(tokens, [t.device for t in tok])):
        local = ids - s * n
        hit = (local >= 0) & (local < n)
        local = local.clamp(0, n - 1)
        table = tok[s].to(dt)
        parts.append(torch.stack([
            torch.where(hit[:, kb, :, None] if cfg.n_codebooks > 1 else hit[..., None],
                        table[kb][local[:, kb] if cfg.n_codebooks > 1 else local], 0)
            for kb in range(cfg.n_codebooks)]))
    if seq:
        return TP.reduce_scatter_seq(parts, dim=2)
    return list(TP.reduce_sum(parts, tokens.device))


def logit_slices(params, cfg: ModelConfig, x, skip: int = 0):
    """The head over a normed x (B, S, d), whole or in sequence slices,
    from position ``skip`` on (a VLM's text positions) → each shard's
    columns of the logits (B, S - skip, c) on its device, in shard order,
    where the head is held in vocabulary slices (the whole sequence sent to
    each shard first, ``tp.spread``); else None."""
    w = params["tok"] if cfg.tie_embeddings else params["head"]
    if not isinstance(w, tuple):
        return None
    return [_logits(cfg, xs[:, skip:], w_s)
            for xs, w_s in zip(TP.spread(x, [t.device for t in w]), w)]


def lm_logits(params, cfg: ModelConfig, x, tp: int, skip: int = 0) -> torch.Tensor:
    """x (B, S, d), whole or in sequence slices → logits from position
    ``skip`` on, on x's (first) device: (B, S - skip, V_padded), or
    (B, S - skip, K, V) for multi-codebook."""
    v = cfg.padded_vocab(tp)
    parts = logit_slices(params, cfg, x, skip)
    if parts is not None:
        # each shard's columns of the logits, joined on x's device
        logits = TP.join(parts, -1, x.device)
    else:
        x = TP.join_seq(x)[:, skip:]
        logits = _logits(cfg, x, params["tok"] if cfg.tie_embeddings else params["head"])
    if cfg.n_codebooks > 1:
        B, S, _ = logits.shape
        return logits.reshape(B, S, cfg.n_codebooks, v)
    return logits


def _logits(cfg: ModelConfig, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, w[0].to(x.dtype))
    return x @ w.to(x.dtype)
