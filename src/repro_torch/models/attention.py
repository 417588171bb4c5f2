"""GQA attention block: projections + RoPE + (qk-norm) + kernel dispatch +
KV caches (full, sliding-window ring buffer).

Without a cache (training, a cache-free forward) the block runs
``kernels.ops.attention``: the flash_attention kernels and their backward on
the card.  With a cache (prefill and decode) it appends to the cache and
attends densely in float32, as the reference does.  The reference's split-S
decode over a sequence-sharded cache exists only under a ``tp > 1`` mesh and
is not ported (ROADMAP A7).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels import ops as kops
from .base import ParamSpec, ShardCtx, matrix_spec, replicated_spec
from .layers import apply_rope, compute_dtype, rms_head_norm, rope_freqs


def attn_spec(cfg: ModelConfig, ctx: ShardCtx) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    qh, kvh, hd = cfg.n_q_heads, cfg.n_kv_heads, cfg.head_dim
    out = {
        "wq": matrix_spec(ctx, (d, qh * hd)),
        "wk": matrix_spec(ctx, (d, kvh * hd)),
        "wv": matrix_spec(ctx, (d, kvh * hd)),
        "wo": matrix_spec(ctx, (qh * hd, d)),
    }
    if cfg.qk_norm:
        out["q_norm"] = replicated_spec((hd,), "ones")
        out["k_norm"] = replicated_spec((hd,), "ones")
    return out


@dataclass
class KVCache:
    """Contiguous cache (full attention) or ring buffer (sliding window)."""

    k: torch.Tensor  # (B, Hkv, C, D)
    v: torch.Tensor  # (B, Hkv, C, D)
    pos: torch.Tensor  # scalar int32: tokens seen so far

    @property
    def capacity(self) -> int:
        return self.k.shape[2]

    def tensors(self):
        return (self.k, self.v, self.pos)


def init_kv_cache(cfg: ModelConfig, batch: int, capacity: int, window: Optional[int] = None,
                  device=None) -> KVCache:
    cap = min(capacity, window) if window else capacity
    dt = compute_dtype(cfg)
    shape = (batch, cfg.n_kv_heads, cap, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dt, device=device),
                   v=torch.zeros(shape, dtype=dt, device=device),
                   pos=torch.zeros((), dtype=torch.int32, device=device))


def _project_qkv(params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    B, S, _ = x.shape
    dt = x.dtype
    q = (x @ params["wq"].to(dt)).reshape(B, S, cfg.n_q_heads, cfg.head_dim)
    k = (x @ params["wk"].to(dt)).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ params["wv"].to(dt)).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_head_norm(params["q_norm"], q)
        k = rms_head_norm(params["k_norm"], k)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, S, D)
    cos, sin = rope_freqs(cfg, positions)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v.contiguous()


def _write(buf: torch.Tensor, new: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """``lax.dynamic_update_slice(buf, new, (0, 0, slot, 0))``: the start is
    clamped so that the S new rows fit, as XLA clamps it."""
    cap, S = buf.shape[2], new.shape[2]
    if S > cap:
        raise ValueError(f"cache write of {S} tokens into a capacity of {cap}")
    start = torch.clamp(slot.to(torch.int64), 0, cap - S)
    idx = start + torch.arange(S, device=buf.device)
    return buf.index_copy(2, idx, new.to(buf.dtype))


def attention_block(
    params,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, d)
    positions: torch.Tensor,  # (B, S)
    window: Optional[int] = None,
    cache: Optional[KVCache] = None,
    ctx: Optional[ShardCtx] = None,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Full-sequence (train / prefill) or cached (decode) attention."""
    if ctx is not None and ctx.tp > 1:
        raise NotImplementedError("attention under tensor parallelism (split-S decode) is "
                                  "not ported (ROADMAP A7)")
    B, S, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x, positions)

    if cache is None:
        out = kops.attention(q, k, v, causal=True, window=window)
        new_cache = None
    else:
        # append to the cache (a ring buffer for windowed attention)
        cap = cache.capacity
        ring = window is not None and cap == window
        slot = cache.pos % cap if ring else cache.pos
        k_new, v_new = _write(cache.k, k, slot), _write(cache.v, v, slot)
        new_cache = KVCache(k=k_new, v=v_new, pos=cache.pos + S)
        # causal within the block just written, and only written slots.  For
        # the contiguous cache a slot is an absolute position; in the ring
        # every resident entry is within the window, so "written" and the
        # block's own causality are the only constraints.
        dev = x.device
        kpos = torch.arange(cap, device=dev)[None, :]  # (1, cap) slot ids
        rows = torch.arange(S, device=dev)[:, None]  # (S, 1)
        if ring:
            kslot_new = (cache.pos + torch.arange(S, device=dev)) % cap
            written = kpos < torch.clamp(cache.pos + S, max=cap)
            new_order = torch.where(kpos == kslot_new[:, None], rows, -1)
            causal_new = (new_order <= rows) | (new_order < 0)
            valid = written & causal_new
        else:
            valid = (kpos <= cache.pos + rows) & (kpos < cache.pos + S)
        group = cfg.n_q_heads // cfg.n_kv_heads
        qf = q.float() * (cfg.head_dim ** -0.5)
        kf = k_new.float().repeat_interleave(group, dim=1)
        vf = v_new.float().repeat_interleave(group, dim=1)
        logits = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
        logits = logits.masked_fill(~valid[None, None], float("-inf"))
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bhkd->bhqd", probs, vf).to(x.dtype)

    out = out.transpose(1, 2).reshape(B, S, cfg.n_q_heads * cfg.head_dim)
    return out @ params["wo"].to(x.dtype), new_cache
