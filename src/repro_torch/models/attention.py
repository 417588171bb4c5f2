"""GQA attention block: projections + RoPE + (qk-norm) + kernel dispatch +
KV caches (full, sliding-window ring buffer).

Without a cache (training, a cache-free forward) the block runs
``kernels.ops.attention``: the flash_attention kernels and their backward on
the card.  With a cache (prefill and decode) it appends to the cache and
attends densely in float32, as the reference does.

Split-S decode (FlashDecoding-style), under the reference's condition: one
token, a model mesh with ``tp > 1``, a contiguous cache (not the window
ring) whose capacity divides by ``tp``.  The cache is then a
:class:`ShardedKVCache`: model shard ``s`` holds slots ``[s·c_loc,
(s+1)·c_loc)`` on its own device, writes the new token there if the slot is
its own, and computes a partial attention over its slice
(:func:`partial_decode_attention`); only the partials ``(o, m, l)`` go to
the row's first device, where :func:`combine_partial_attention` adds them
in shard order.  A prefill into a sharded cache runs the dense cached path
on the gathered cache and puts the written cache back on its shards.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels import ops as kops
from . import tp as TP
from .base import ParamSpec, ShardCtx, matrix_spec, replicated_spec
from .layers import apply_rope, compute_dtype, rms_head_norm, rope_freqs


def attn_spec(cfg: ModelConfig, ctx: ShardCtx) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    qh, kvh, hd = cfg.n_q_heads, cfg.n_kv_heads, cfg.head_dim
    tp_ok = cfg.attn_tp_eligible(ctx.tp)
    kv_ok = cfg.kv_sharded(ctx.tp)
    out = {
        "wq": matrix_spec(ctx, (d, qh * hd), tp_dim=1 if tp_ok else None, fsdp_dim=0),
        "wk": matrix_spec(ctx, (d, kvh * hd), tp_dim=1 if kv_ok else None, fsdp_dim=0),
        "wv": matrix_spec(ctx, (d, kvh * hd), tp_dim=1 if kv_ok else None, fsdp_dim=0),
        "wo": matrix_spec(ctx, (qh * hd, d), tp_dim=0 if tp_ok else None, fsdp_dim=1),
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


@dataclass
class ShardedKVCache:
    """A contiguous cache split along its slots over a data row's model
    shards: ``k[s]`` and ``v[s]`` (B, Hkv, C / tp, D) hold slots
    ``[s·C/tp, (s+1)·C/tp)`` on shard ``s``'s device; ``pos`` lies on the
    row's first device."""

    k: Tuple[torch.Tensor, ...]
    v: Tuple[torch.Tensor, ...]
    pos: torch.Tensor

    @property
    def capacity(self) -> int:
        return sum(t.shape[2] for t in self.k)

    def tensors(self):
        return (*self.k, *self.v, self.pos)

    @classmethod
    def split(cls, cache: KVCache, devices: Sequence[torch.device]) -> "ShardedKVCache":
        c = cache.capacity // len(devices)

        def parts(buf):
            return tuple(buf[:, :, s * c:(s + 1) * c].to(dev).contiguous()
                         for s, dev in enumerate(devices))

        return cls(parts(cache.k), parts(cache.v), cache.pos)

    def gathered(self) -> KVCache:
        dev = self.pos.device
        return KVCache(k=torch.cat([t.to(dev) for t in self.k], dim=2),
                       v=torch.cat([t.to(dev) for t in self.v], dim=2), pos=self.pos)


def split_s_eligible(capacity: int, window: Optional[int], tp: int) -> bool:
    """The reference's condition for split-S decode, less the one token:
    ``tp > 1`` and a contiguous cache (not the window ring) whose capacity
    divides by ``tp``."""
    return tp > 1 and (window is None or capacity != window) and capacity % tp == 0


def init_kv_cache(cfg: ModelConfig, batch: int, capacity: int, window: Optional[int] = None,
                  device=None, shards: Optional[Sequence[torch.device]] = None):
    """A zero cache on ``device``; given a data row's model ``shards`` where
    split-S decode applies, a :class:`ShardedKVCache` over them (``pos`` on
    the first)."""
    cap = min(capacity, window) if window else capacity
    dt = compute_dtype(cfg)
    if shards is not None and split_s_eligible(cap, window, len(shards)):
        shape = (batch, cfg.n_kv_heads, cap // len(shards), cfg.head_dim)
        return ShardedKVCache(
            k=tuple(torch.zeros(shape, dtype=dt, device=d) for d in shards),
            v=tuple(torch.zeros(shape, dtype=dt, device=d) for d in shards),
            pos=torch.zeros((), dtype=torch.int32, device=shards[0]))
    shape = (batch, cfg.n_kv_heads, cap, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dt, device=device),
                   v=torch.zeros(shape, dtype=dt, device=device),
                   pos=torch.zeros((), dtype=torch.int32, device=device))


def _heads(cfg: ModelConfig, x: torch.Tensor, w: torch.Tensor, norm=None) -> torch.Tensor:
    """x (B, S, d) @ w (d, H·D) → (B, H, S, D), qk-normed by ``norm``."""
    B, S, _ = x.shape
    t = (x @ w.to(x.dtype)).reshape(B, S, -1, cfg.head_dim)
    if norm is not None:
        t = rms_head_norm(norm.to(t.device), t)
    return t.transpose(1, 2)


def _project_qkv(params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    q = _heads(cfg, x, params["wq"], params.get("q_norm"))
    k = _heads(cfg, x, params["wk"], params.get("k_norm"))
    v = _heads(cfg, x, params["wv"])
    cos, sin = rope_freqs(cfg, positions)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v.contiguous()


def _project_tp(params, cfg: ModelConfig, x, positions: torch.Tensor):
    """The q, k and v heads of a block whose ``wq`` (and ``wo``) are held
    in head slices over the shards → ([(q_s, k_s, v_s) on shard s's
    device], the whole (k, v) on x's device or None).  Each shard projects
    its own q heads and, where ``wk`` / ``wv`` are sliced too, its own kv
    heads; else k and v are projected once with the whole weights on x's
    device, and each shard takes the kv heads its q heads read (a group's
    head, its run of heads, or one kv head a q head where the groups cut
    across the shards).  What every shard reads (the qk-norm scales, the
    whole k and v) goes out by :func:`tp.broadcast`, so that its gradient
    comes back added in shard order; x goes out whole by ``tp.spread`` (a
    broadcast, or the gather of its sequence slices)."""
    wq = params["wq"]
    devs = [w.device for w in wq]
    n = len(devs)
    kv_split = isinstance(params["wk"], tuple)
    xs_all = TP.spread(x, devs)
    whole = None
    if not kv_split:
        cos, sin = rope_freqs(cfg, positions)
        xw = x if isinstance(x, torch.Tensor) else xs_all[0]  # shard 0's: x's device
        whole = (apply_rope(_heads(cfg, xw, params["wk"], params.get("k_norm")), cos, sin),
                 _heads(cfg, xw, params["wv"]).contiguous())
        kv = [TP.broadcast(t, devs) for t in whole]
    norms = {k: TP.broadcast(params[k], devs) for k in ("q_norm", "k_norm")
             if params.get(k) is not None}
    hq = cfg.n_q_heads // n
    group = cfg.n_q_heads // cfg.n_kv_heads
    out = []
    for s, (xs, ps) in enumerate(zip(xs_all, TP.broadcast(positions, devs))):
        shard = {"wq": wq[s], **{k: v[s] for k, v in norms.items()}}
        if kv_split:
            shard.update(wk=params["wk"][s], wv=params["wv"][s])
            out.append(_project_qkv(shard, cfg, xs, ps))
            continue
        cos, sin = rope_freqs(cfg, ps)
        q = apply_rope(_heads(cfg, xs, wq[s], shard.get("q_norm")), cos, sin)
        heads = torch.arange(s * hq, (s + 1) * hq, device=xs.device) // group
        if group % hq == 0:  # the shard's q heads share one kv head
            heads = heads[:1]
        out.append((q, kv[0][s][:, heads], kv[1][s][:, heads]))
    return out, whole


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
    cache=None,
    mesh=None,
    ctx: Optional[ShardCtx] = None,
):
    """Full-sequence (train / prefill) or cached (decode) attention.
    ``mesh``: the data row's model mesh (one data row; ``lm.forward``
    splits a batch over the rows).

    Weights in head slices over the row's model shards (``params["wq"]``
    a tuple, ``models/tp.py``): without a cache each shard attends over its
    own heads on its own device (the flash_attention kernel at the shard's
    shape); with one, the shards' q, k and v heads join on x's device, where
    the cache (or, split-S, its slots' shards) lies, and the output goes
    back to each shard's heads.  Each shard multiplies its heads by its rows
    of ``wo``, and the parts add on x's device in shard order.

    x in sequence slices (``tp.SeqSlices``, no cache): the slices are
    gathered whole onto each shard for the projections, and the parts of
    ``wo`` reduce-scattered back into slices; with whole weights, the
    slices join on the first device and the output is cut back."""
    B, S, _ = x.shape
    if mesh is not None and mesh.dp_total != 1:
        raise ValueError(f"attention_block runs one data row; the mesh has {mesh.dp_total}")
    if isinstance(x, TP.SeqSlices) and not isinstance(params["wq"], tuple):
        return TP.on_whole(lambda t: attention_block(params, cfg, t, positions, window, cache,
                                                     mesh, ctx), x)
    if isinstance(params["wq"], tuple):
        wo = params["wo"]
        devs = [w.device for w in wo]
        heads, whole = _project_tp(params, cfg, x, positions)
        if cache is None:
            outs = [kops.attention(q, k, v, causal=True, window=window) for q, k, v in heads]
            new_cache = None
        else:
            q = TP.join([h[0] for h in heads], 1, x.device)
            k, v = whole or (TP.join([h[i] for h in heads], 1, x.device) for i in (1, 2))
            out, new_cache = _attend_cached(cfg, q, k, v, cache, window, mesh, ctx)
            outs = TP.scatter(out.chunk(len(devs), dim=1), devs)
        parts = [o.transpose(1, 2).reshape(B, S, -1) @ w.to(x.dtype) for o, w in zip(outs, wo)]
        return TP.collect(parts, x), new_cache

    q, k, v = _project_qkv(params, cfg, x, positions)
    if cache is None:
        out, new_cache = kops.attention(q, k, v, causal=True, window=window), None
    else:
        out, new_cache = _attend_cached(cfg, q, k, v, cache, window, mesh, ctx)
    out = out.transpose(1, 2).reshape(B, S, cfg.n_q_heads * cfg.head_dim)
    return out @ params["wo"].to(x.dtype), new_cache


def _attend_cached(cfg: ModelConfig, q, k, v, cache, window, mesh, ctx):
    """q (B, Hq, S, D), k / v (B, Hkv, S, D) roped, on the cache's (first)
    device, appended to the cache and attended → (out (B, Hq, S, D) in q's
    type, the written cache).  One token over a mesh under the reference's
    condition decodes split-S."""
    S = q.shape[2]
    use_split_s = (S == 1 and mesh is not None and ctx is not None and ctx.tp > 1
                   and split_s_eligible(cache.capacity, window, ctx.tp))
    if use_split_s:
        if isinstance(cache, KVCache):
            cache = ShardedKVCache.split(cache, mesh.row_devices(0))
        out, new_cache = _split_s_decode(q * (cfg.head_dim ** -0.5), k, v, cache)
        return out.to(q.dtype)[:, :, None, :], new_cache  # (B, Hq, 1, D)

    sharded = cache if isinstance(cache, ShardedKVCache) else None
    if sharded is not None:
        cache = sharded.gathered()
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
    dev = q.device
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
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vf).to(q.dtype)
    if sharded is not None:  # the written cache back on its shards
        new_cache = ShardedKVCache.split(new_cache, [t.device for t in sharded.k])
    return out, new_cache


def _split_s_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    cache: ShardedKVCache) -> Tuple[torch.Tensor, ShardedKVCache]:
    """One token against a slot-sharded cache: q (B, Hq, 1, D) scaled and
    roped, k / v (B, Hkv, 1, D) the token's → ((B, Hq, D) float32 on the
    row's first device, the written cache).  Each shard writes the token
    if its slot (``pos``, clamped into the cache as XLA clamps an update)
    is its own, and attends over its written slots; the partials combine
    on the first device in shard order."""
    first = cache.pos.device
    c = cache.k[0].shape[2]
    slot = torch.clamp(cache.pos.to(torch.int64), 0, cache.capacity - 1)
    ks, vs, parts = [], [], []
    for s, (k_s, v_s) in enumerate(zip(cache.k, cache.v)):
        dev = k_s.device
        slots = s * c + torch.arange(c, device=dev)
        hit = (slots == slot.to(dev))[None, None, :, None]
        k_s = torch.where(hit, k.to(device=dev, dtype=k_s.dtype), k_s)
        v_s = torch.where(hit, v.to(device=dev, dtype=v_s.dtype), v_s)
        valid = (slots <= cache.pos.to(dev))[None, :].expand(q.shape[0], c)
        o, m, l = partial_decode_attention(q.to(dev), k_s, v_s, valid)
        parts.append((o.to(first), m.to(first), l.to(first)))
        ks.append(k_s)
        vs.append(v_s)
    out = combine_partial_attention(*zip(*parts))
    return out, ShardedKVCache(tuple(ks), tuple(vs), cache.pos + 1)


# ------------------------------------------------- split-S decode (serving) --


def partial_decode_attention(q: torch.Tensor, k_shard: torch.Tensor, v_shard: torch.Tensor,
                             valid: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """FlashDecoding-style partial attention over one cache shard: q (B,
    Hq, 1, D) scaled and roped, k / v (B, Hkv, C_shard, D), valid (B,
    C_shard) → (o (B, Hq, D), m (B, Hq), l (B, Hq)), float32, combinable
    across shards.  GQA groups the q heads over the cache's heads; the
    logits and the PV product sum in float32 over the cache's values, and
    p is cast to the cache's type before the PV product, as in the
    reference.  A shard with no valid slot gives m = -1e30, l = 0, o = 0."""
    B, Hq, _, D = q.shape
    Hkv = k_shard.shape[1]
    qg = q[:, :, 0, :].reshape(B, Hkv, Hq // Hkv, D)
    logits = torch.einsum("bhgd,bhkd->bhgk", qg.float(), k_shard.float())
    mask = valid[:, None, None]
    logits = logits.masked_fill(~mask, float("-inf"))
    m = logits.amax(-1)  # (B, Hkv, G)
    p = torch.where(mask, torch.exp(logits - m[..., None]), 0.0)
    l = p.sum(-1)
    o = torch.einsum("bhgk,bhkd->bhgd", p.to(k_shard.dtype).float(), v_shard.float())
    safe_m = torch.where(torch.isfinite(m), m, -1e30)
    return o.reshape(B, Hq, D), safe_m.reshape(B, Hq), l.reshape(B, Hq)


def combine_partial_attention(os: Sequence[torch.Tensor], ms: Sequence[torch.Tensor],
                              ls: Sequence[torch.Tensor]) -> torch.Tensor:
    """The shards' partials (in shard order, on one device) combined with
    the global running max: Σ o_i·exp(m_i − m) / max(Σ l_i·exp(m_i − m),
    1e-30), the sums added in shard order (the reference's ``pmax`` and
    ``psum`` over the model axis)."""
    m_glob = ms[0]
    for m in ms[1:]:
        m_glob = torch.maximum(m_glob, m)
    o_sum = l_sum = None
    for o, m, l in zip(os, ms, ls):
        scale = torch.exp(m - m_glob)
        o_s, l_s = o * scale[..., None], l * scale
        o_sum = o_s if o_sum is None else o_sum + o_s
        l_sum = l_s if l_sum is None else l_sum + l_s
    return o_sum / torch.clamp(l_sum, min=1e-30)[..., None]
