"""GQA attention block: projections + RoPE + (qk-norm) + kernel dispatch +
KV caches (full, sliding-window ring buffer).

Without a cache (training, a cache-free forward) the block runs
``kernels.ops.attention``: the flash_attention kernels and their backward on
the card.  With a cache (prefill and decode) it appends to the cache and
attends densely in float32, as the reference does.

Over a data row's model shards a cache lies where the reference's
``make_cache_specs`` places it (``launch/specs.py``), as a
:class:`ShardedKVCache` split along one dimension of (B, Hkv, C, D):

* by kv heads (``dim`` 1) where they divide ``tp`` (``cfg.kv_sharded``), the
  contiguous cache and the window ring alike: shard ``s`` holds heads
  ``[s·Hkv/tp, (s+1)·Hkv/tp)`` on its own device.  Each shard writes and
  attends its own q heads there (with the weights in head slices, the q,
  k and v it projects itself; with whole weights, its heads of them sent
  out), and only its output leaves: no q, k or v is joined.  A decode step
  under the reference's split-S condition keeps the reference's split-S
  arithmetic on the shard's heads: the partials of the ``tp`` slot blocks
  in one batched product (:func:`partial_decode_attention`), combined in
  block order (:func:`combine_partial_attention`), so every head's value is
  the slot-split decode's bit for bit;
* by slots (``dim`` 2, split-S decode, FlashDecoding-style) where the kv
  heads do not divide and the reference's condition holds: ``tp > 1`` and
  a contiguous cache (not the window ring) whose capacity divides by
  ``tp``.  Shard ``s`` holds slots ``[s·c_loc, (s+1)·c_loc)``; a decode step
  writes the new token there if the slot is its own and computes a partial
  attention over its slice; only the partials ``(o, m, l)`` go to the row's
  first device, where :func:`combine_partial_attention` adds them in shard
  order.  A multi-token write sends each shard only the new tokens its
  slots can take, which it writes there, and the dense cached path reads a
  copy of the written slots gathered on the first device.

The window ring whose kv heads do not divide ``tp`` stays whole on the row's
first device, the one exception to ``make_cache_specs``: the reference
attends a ring densely, so a ring split by slots would be gathered every
step.
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
    """A cache split along dimension ``dim`` of (B, Hkv, C, D) over a data
    row's model shards, ``k[s]`` and ``v[s]`` on shard ``s``'s device: its
    slots (``dim`` 2, split-S: slots ``[s·C/tp, (s+1)·C/tp)``) or its kv heads
    (``dim`` 1: heads ``[s·Hkv/tp, (s+1)·Hkv/tp)``); ``pos`` lies on the row's
    first device."""

    k: Tuple[torch.Tensor, ...]
    v: Tuple[torch.Tensor, ...]
    pos: torch.Tensor
    dim: int = 2

    @property
    def capacity(self) -> int:
        c = self.k[0].shape[2]
        return c * len(self.k) if self.dim == 2 else c

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        return tuple(t.device for t in self.k)

    def tensors(self):
        return (*self.k, *self.v, self.pos)

    @classmethod
    def split(cls, cache: KVCache, devices: Sequence[torch.device],
              dim: int = 2) -> "ShardedKVCache":
        def parts(buf):
            return tuple(t.to(dev).contiguous()
                         for t, dev in zip(buf.chunk(len(devices), dim), devices))

        return cls(parts(cache.k), parts(cache.v), cache.pos, dim)

    def gathered(self) -> KVCache:
        dev = self.pos.device
        return KVCache(k=torch.cat([t.to(dev) for t in self.k], dim=self.dim),
                       v=torch.cat([t.to(dev) for t in self.v], dim=self.dim), pos=self.pos)


def split_s_eligible(capacity: int, window: Optional[int], tp: int) -> bool:
    """The reference's condition for split-S decode, less the one token:
    ``tp > 1`` and a contiguous cache (not the window ring) whose capacity
    divides by ``tp``."""
    return tp > 1 and (window is None or capacity != window) and capacity % tp == 0


def init_kv_cache(cfg: ModelConfig, batch: int, capacity: int, window: Optional[int] = None,
                  device=None):
    """A zero cache on ``device`` (``lm.init_cache(mesh=...)`` places one
    over a data row's model shards)."""
    cap = min(capacity, window) if window else capacity
    dt = compute_dtype(cfg)
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
    a tuple, ``models/tp.py``): without a cache, or with one by kv heads,
    each shard attends over its own heads on its own device (without a
    cache the flash_attention kernel at the shard's shape); with a cache
    by slots or whole, the shards' q, k and v heads join on x's device,
    where the cache (or, split-S, its first slots) lies, and the output
    goes back to each shard's heads.  Each shard multiplies its heads by
    its rows of ``wo``, and the parts add on x's device in shard order.
    Whole weights with a cache by kv heads: each shard's heads of q, k and
    v go out to it, and the outputs join on x's device.

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
    by_heads = isinstance(cache, ShardedKVCache) and cache.dim == 1
    if isinstance(params["wq"], tuple):
        wo = params["wo"]
        devs = [w.device for w in wo]
        heads, whole = _project_tp(params, cfg, x, positions)
        if cache is None:
            outs = [kops.attention(q, k, v, causal=True, window=window) for q, k, v in heads]
            new_cache = None
        elif by_heads:
            if cache.devices != tuple(devs) or whole is not None:
                raise ValueError("a cache by kv heads over other shards than the weights' heads")
            outs, new_cache = _attend_by_heads(cfg, heads, cache, window)
        else:
            q = TP.join([h[0] for h in heads], 1, x.device)
            k, v = whole or (TP.join([h[i] for h in heads], 1, x.device) for i in (1, 2))
            out, new_cache = _attend_cached(cfg, q, k, v, cache, window, mesh, ctx)
            outs = TP.scatter([o.contiguous() for o in out.chunk(len(devs), dim=1)], devs)
        parts = [o.transpose(1, 2).reshape(B, S, -1) @ w.to(x.dtype) for o, w in zip(outs, wo)]
        return TP.collect(parts, x), new_cache

    q, k, v = _project_qkv(params, cfg, x, positions)
    if cache is None:
        out, new_cache = kops.attention(q, k, v, causal=True, window=window), None
    elif by_heads:
        devs = cache.devices
        heads = TP.send(list(zip(*(t.chunk(len(devs), dim=1) for t in (q, k, v)))), devs)
        outs, new_cache = _attend_by_heads(cfg, heads, cache, window)
        out = TP.join(outs, 1, x.device)
    else:
        out, new_cache = _attend_cached(cfg, q, k, v, cache, window, mesh, ctx)
    out = out.transpose(1, 2).reshape(B, S, cfg.n_q_heads * cfg.head_dim)
    return out @ params["wo"].to(x.dtype), new_cache


def _attend_by_heads(cfg: ModelConfig, heads, cache: ShardedKVCache, window):
    """Each shard's (q, k, v) heads (q (B, Hq/tp, S, D) roped, k / v (B,
    Hkv/tp, S, D), on the shard's device) written into and attended against
    its slice of a cache by kv heads, where they lie → ([each shard's out
    (B, Hq/tp, S, D) in q's type, on its device], the written cache).  One
    token under the reference's split-S condition: the split-S arithmetic
    on the shard's heads (:func:`_blocks_decode`); else the dense cached
    arithmetic (:func:`_dense_cached`)."""
    devs = cache.devices
    cap = cache.capacity
    S = heads[0][0].shape[2]
    ring = window is not None and cap == window
    split_s = S == 1 and split_s_eligible(cap, window, len(devs))
    scale = cfg.head_dim ** -0.5
    outs, ks, vs = [], [], []
    for (q, k, v), k_c, v_c, pos in zip(heads, cache.k, cache.v,
                                        TP.broadcast(cache.pos, devs)):
        if split_s:
            out, k_c, v_c = _blocks_decode(q * scale, k, v, k_c, v_c, pos, len(devs))
            out = out.to(q.dtype)[:, :, None, :]
        else:
            slot = pos % cap if ring else pos
            k_c, v_c = _write(k_c, k, slot), _write(v_c, v, slot)
            out = _dense_cached(q, k_c, v_c, pos, ring, scale)
        outs.append(out)
        ks.append(k_c)
        vs.append(v_c)
    return outs, ShardedKVCache(tuple(ks), tuple(vs), cache.pos + S, dim=1)


def _blocks_decode(q, k, v, k_c, v_c, pos, blocks: int):
    """One token against one shard's kv heads of a contiguous cache, with
    the reference's split-S arithmetic: q (B, H, 1, D) scaled and roped, k
    / v (B, Hkv, 1, D) the token's, k_c / v_c (B, Hkv, C, D) → ((B, H, D)
    float32, the written k_c, v_c).  The token is written at ``pos``
    (clamped into the cache as XLA clamps an update); the C slots are taken
    as ``blocks`` blocks of C / blocks (the slot-split shards' slices),
    whose partials form in one batched product and combine in block order:
    for each head the values of :func:`_split_s_decode`."""
    B, Hkv, C, D = k_c.shape
    c = C // blocks
    k_c, v_c = _write(k_c, k, pos), _write(v_c, v, pos)
    valid = (torch.arange(C, device=pos.device) <= pos).reshape(blocks, c)[None].expand(
        B, blocks, c)
    o, m, l = partial_decode_attention(q, k_c.view(B, Hkv, blocks, c, D),
                                       v_c.view(B, Hkv, blocks, c, D), valid)
    return _combine_blocks(o, m, l), k_c, v_c


def _combine_blocks(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """:func:`combine_partial_attention` of blocks held in one tensor (o (B, T,
    H, D), m and l (B, T, H)): the maximum (exact in any order), each
    block's scale and scaled terms at once, and the sums in block order."""
    m_glob = m.amax(1, keepdim=True)
    scale = torch.exp(m - m_glob)
    o_s, l_s = o * scale[..., None], l * scale
    o_sum, l_sum = o_s[:, 0], l_s[:, 0]
    for t in range(1, o.shape[1]):
        o_sum, l_sum = o_sum + o_s[:, t], l_sum + l_s[:, t]
    return o_sum / torch.clamp(l_sum, min=1e-30)[..., None]


def _dense_cached(q, k_c, v_c, pos, ring: bool, scale: float):
    """The dense cached arithmetic (the reference's): q (B, Hq, S, D) roped,
    the written k_c / v_c (B, Hkv, C, D), ``pos`` the tokens seen before
    these S → out (B, Hq, S, D) in q's type.  Causal within the block just
    written, and only written slots: for the contiguous cache a slot is an
    absolute position; in the ring every resident entry is within the
    window, so "written" and the block's own causality are the only
    constraints."""
    S, cap = q.shape[2], k_c.shape[2]
    dev = q.device
    kpos = torch.arange(cap, device=dev)[None, :]  # (1, cap) slot ids
    rows = torch.arange(S, device=dev)[:, None]  # (S, 1)
    if ring:
        kslot_new = (pos + torch.arange(S, device=dev)) % cap
        written = kpos < torch.clamp(pos + S, max=cap)
        new_order = torch.where(kpos == kslot_new[:, None], rows, -1)
        causal_new = (new_order <= rows) | (new_order < 0)
        valid = written & causal_new
    else:
        valid = (kpos <= pos + rows) & (kpos < pos + S)
    group = q.shape[1] // k_c.shape[1]
    qf = q.float() * scale
    kf = k_c.float().repeat_interleave(group, dim=1)
    vf = v_c.float().repeat_interleave(group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    logits = logits.masked_fill(~valid[None, None], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vf).to(q.dtype)


def _attend_cached(cfg: ModelConfig, q, k, v, cache, window, mesh, ctx):
    """q (B, Hq, S, D), k / v (B, Hkv, S, D) roped, on the cache's (first)
    device, appended to a whole cache or one by slots and attended → (out
    (B, Hq, S, D) in q's type, the written cache).  One token over a mesh
    under the reference's condition decodes split-S; more into a cache by
    slots are written where their slots lie (:func:`_write_slots`), and
    the dense path reads the written slots gathered on the first device."""
    S = q.shape[2]
    use_split_s = (S == 1 and mesh is not None and ctx is not None and ctx.tp > 1
                   and split_s_eligible(cache.capacity, window, ctx.tp))
    if use_split_s:
        if isinstance(cache, KVCache):
            cache = ShardedKVCache.split(cache, mesh.row_devices(0))
        out, new_cache = _split_s_decode(q * (cfg.head_dim ** -0.5), k, v, cache)
        return out.to(q.dtype)[:, :, None, :], new_cache  # (B, Hq, 1, D)

    cap = cache.capacity
    ring = window is not None and cap == window
    if isinstance(cache, ShardedKVCache):
        new_cache = _write_slots(cache, k, v)
        k_new, v_new = (TP.join(t, 2, q.device) for t in (new_cache.k, new_cache.v))
    else:
        slot = cache.pos % cap if ring else cache.pos
        k_new, v_new = _write(cache.k, k, slot), _write(cache.v, v, slot)
        new_cache = KVCache(k=k_new, v=v_new, pos=cache.pos + S)
    return _dense_cached(q, k_new, v_new, cache.pos, ring, cfg.head_dim ** -0.5), new_cache


def _write_slots(cache: ShardedKVCache, k: torch.Tensor, v: torch.Tensor) -> ShardedKVCache:
    """S new tokens (k / v (B, Hkv, S, D) on the first device) written into a
    cache by slots where ``_write`` would put them (from ``pos``, clamped so
    that they fit), each shard writing on its device the ones its slots
    own.  Sync-free: shard ``s`` (slots ``[s·c, (s+1)·c)``) takes at most w =
    min(S, c) of them, so it is sent the w tokens from a_s = clamp(s·c −
    start, 0, S − w), cut on the first device by a device-side index, with
    (s·c − start, a_s), in one move."""
    devs = cache.devices
    n, c, S = len(devs), cache.k[0].shape[2], k.shape[2]
    if S > cache.capacity:
        raise ValueError(f"cache write of {S} tokens into a capacity of {cache.capacity}")
    w = min(S, c)
    dev = k.device
    start = torch.clamp(cache.pos.to(device=dev, dtype=torch.int64), 0, cache.capacity - S)
    first = torch.arange(n, device=dev) * c - start  # the token each shard's first slot takes
    offs = torch.stack([first, first.clamp(0, S - w)], 1)  # (n, 2)
    idx = (offs[:, 1:] + torch.arange(w, device=dev)).reshape(-1)
    k_w, v_w = (t.index_select(2, idx).chunk(n, 2) for t in (k, v))
    ks, vs = [], []
    for k_c, v_c, (o, k_s, v_s) in zip(cache.k, cache.v, TP.send(
            list(zip(offs.unbind(0), k_w, v_w)), devs)):
        token = o[0] + torch.arange(c, device=k_c.device)  # the token each slot takes
        hit = ((token >= 0) & (token < S))[None, None, :, None]
        j = (token - o[1]).clamp(0, w - 1)
        ks.append(torch.where(hit, k_s.index_select(2, j).to(k_c.dtype), k_c))
        vs.append(torch.where(hit, v_s.index_select(2, j).to(v_c.dtype), v_c))
    return ShardedKVCache(tuple(ks), tuple(vs), cache.pos + S)


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
    reference.  A shard with no valid slot gives m = -1e30, l = 0, o = 0.
    T blocks of slots at once: k / v (B, Hkv, T, C_shard, D), valid (B, T,
    C_shard) → o (B, T, Hq, D), m and l (B, T, Hq), each block's the value
    it has alone (one product of (G, D) by (D, C_shard) a batch entry)."""
    blocks = k_shard.dim() == 5
    if not blocks:
        k_shard, v_shard, valid = k_shard[:, :, None], v_shard[:, :, None], valid[:, None]
    B, Hq, _, D = q.shape
    Hkv, T = k_shard.shape[1], k_shard.shape[2]
    qg = q[:, :, 0, :].reshape(B, Hkv, 1, Hq // Hkv, D).expand(B, Hkv, T, Hq // Hkv, D)
    logits = torch.einsum("bhtgd,bhtkd->bhtgk", qg.float(), k_shard.float())
    mask = valid[:, None, :, None]
    logits = logits.masked_fill(~mask, float("-inf"))
    m = logits.amax(-1)  # (B, Hkv, T, G)
    p = torch.where(mask, torch.exp(logits - m[..., None]), 0.0)
    l = p.sum(-1)
    o = torch.einsum("bhtgk,bhtkd->bhtgd", p.to(k_shard.dtype).float(), v_shard.float())
    safe_m = torch.where(torch.isfinite(m), m, -1e30)
    o = o.permute(0, 2, 1, 3, 4).reshape(B, T, Hq, D)
    safe_m = safe_m.permute(0, 2, 1, 3).reshape(B, T, Hq)
    l = l.permute(0, 2, 1, 3).reshape(B, T, Hq)
    if blocks:
        return o, safe_m, l
    return o[:, 0], safe_m[:, 0], l[:, 0]


def combine_partial_attention(os: Sequence[torch.Tensor], ms: Sequence[torch.Tensor],
                              ls: Sequence[torch.Tensor]) -> torch.Tensor:
    """The shards' partials (in shard order, on one device) combined with
    the global running max: Σ o_i·exp(m_i − m) / max(Σ l_i·exp(m_i − m),
    1e-30), the sums added in shard order (the reference's ``pmax`` and
    ``psum`` over the model axis)."""
    return _combine_blocks(torch.stack(list(os), 1), torch.stack(list(ms), 1),
                           torch.stack(list(ls), 1))
