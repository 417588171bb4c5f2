"""Mamba-2 block (SSD — state-space duality, arXiv:2405.21060).

Prefill runs the chunked SSD algorithm (``kernels.ops.ssd_scan``: on the
card one kernel launch for the intra-chunk part, then one for the
inter-chunk state scan and its correction); decode is the O(1) recurrent
update ``h ← a·h + B xᵀ, y = C h`` in plain torch ops, as in the
reference.

Block structure (Mamba-2): in_proj → (z gate, x, B, C, dt) → causal conv1d on
(x, B, C) → SSD → gated RMSNorm → out_proj.

Under tensor parallelism (``models/tp.py``) ``in_proj`` is held as the
reference places it, a plain 1/tp of its columns a shard (the slices cut
across the z / x / B / C / dt segments), and ``out_proj`` by rows: each
shard projects its columns, which join on the row's first device; without a
cache the conv, the scan and the gated RMSNorm run there whole.  With x in
sequence slices (``tp.SeqSlices``, the reference's sequence parallelism) the
slices are gathered whole onto each shard for ``in_proj`` and the parts of
``out_proj`` reduce-scattered back into slices.

A cache over a data row's model shards lies as the reference's
``make_cache_specs`` places it: the state by heads, the conv tail by an
even split of its channels (``di + 2·ns``, which does not line up with the
heads).  The block then computes where the cache lies: each shard runs the
depthwise conv on its channels against its tail (its channels of the
conv's input, weights and bias go out in one move, ``tp.send``; the
output joins on the first device), and the scan (prefill:
``kops.ssd_scan`` at the shard's heads; decode: the one-step recurrence) on
its heads with its state (its heads' x and log a, and the whole B and C,
in one move); the heads' y join
on the first device before the gated RMSNorm, whose mean runs over the
whole ``d_inner`` in today's order.  Every op there acts per head or per
channel.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops as kops
from . import tp as TP
from .base import ParamSpec, ShardCtx, matrix_spec, replicated_spec
from .layers import column_product, row_product


def ssd_dims(cfg: ModelConfig):
    s = cfg.ssd
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    return d_inner, n_heads, s.d_state


def ssd_spec(cfg: ModelConfig, ctx: ShardCtx) -> Dict[str, ParamSpec]:
    s = cfg.ssd
    d = cfg.d_model
    di, nh, ns = ssd_dims(cfg)
    conv_dim = di + 2 * ns  # conv over (x, B, C)
    return {
        "in_proj": matrix_spec(ctx, (d, 2 * di + 2 * ns + nh), tp_dim=1, fsdp_dim=0),
        "conv_w": replicated_spec((s.conv_width, conv_dim), "normal:0.1"),
        "conv_b": replicated_spec((conv_dim,), "zeros"),
        "a_log": replicated_spec((nh,), "zeros"),
        "dt_bias": replicated_spec((nh,), "zeros"),
        "d_skip": replicated_spec((nh,), "ones"),
        "norm_scale": replicated_spec((di,), "ones"),
        "out_proj": matrix_spec(ctx, (di, d), tp_dim=0, fsdp_dim=1),
    }


@dataclass
class SSDCache:
    """Over a data row's model shards (``lm.init_cache(mesh=...)``) ``h`` is
    a tuple of head slices and ``conv`` a tuple of channel slices, slice
    ``s`` on shard ``s``'s device, each where ``tp`` divides it."""

    h: torch.Tensor  # (B, H, N, P) recurrent state, float32
    conv: torch.Tensor  # (B, W-1, conv_dim) conv tail, float32
    pos: torch.Tensor  # scalar int32

    def tensors(self):
        return (*TP.parts_of(self.h), *TP.parts_of(self.conv), self.pos)


def init_ssd_cache(cfg: ModelConfig, batch: int, device) -> SSDCache:
    di, nh, ns = ssd_dims(cfg)
    s = cfg.ssd
    return SSDCache(
        h=torch.zeros((batch, nh, ns, s.head_dim), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, s.conv_width - 1, di + 2 * ns), dtype=torch.float32,
                         device=device),
        pos=torch.zeros((), dtype=torch.int32, device=device),
    )


def _conv_taps(full: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, S: int,
               dt: torch.dtype) -> torch.Tensor:
    """Depthwise causal conv of width W over ``full`` (B, W-1+S, C), summed
    tap by tap in float32 (the reference's float32 weights promote the
    product), then SiLU, then cast to ``dt``."""
    out = 0
    for i in range(w.shape[0]):
        out = out + full[:, i:i + S, :].float() * w[i][None, None, :]
    return F.silu(out + bias).to(dt)


def _ssd_step(h, xh_dt, log_a, bmat, cmat):
    """The single-step recurrence h ← a·h + B xᵀ, y = C h: h (B, H, N, P)
    float32, xh_dt (B, 1, H, P) float32, log_a (B, 1, H), B / C (B, 1, N)
    → (y (B, 1, H, P) float32, the new h)."""
    a_step = torch.exp(log_a[:, 0])  # (B, H)
    outer = torch.einsum("bn,bhp->bhnp", bmat[:, 0].float(), xh_dt[:, 0])
    h_new = a_step[..., None, None] * h + outer
    return torch.einsum("bn,bhnp->bhp", cmat[:, 0].float(), h_new)[:, None], h_new


def ssd_block(
    params,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, d)
    cache: Optional[SSDCache] = None,
) -> Tuple[torch.Tensor, Optional[SSDCache]]:
    s = cfg.ssd
    B, S, d = x.shape
    di, nh, ns = ssd_dims(cfg)
    dt_ = x.dtype
    proj = column_product(x, params["in_proj"])
    z, xs, bmat, cmat, dt_raw = torch.split(proj, [di, di, ns, ns, nh], dim=-1)

    conv_in = torch.cat([xs, bmat, cmat], dim=-1)  # (B, S, di + 2ns)
    W = s.conv_width
    if cache is None:
        full = F.pad(conv_in, (0, 0, W - 1, 0))
        new_conv = None
        conv_out = _conv_taps(full, params["conv_w"], params["conv_b"], S, dt_)
    elif isinstance(cache.conv, tuple):  # each shard its channels, against its tail
        devs = [t.device for t in cache.conv]
        n = len(devs)
        outs, new_conv = [], []
        for tail, (c_in, w, b) in zip(cache.conv, TP.send(list(zip(*(t.chunk(n, -1) for t in (
                conv_in, params["conv_w"], params["conv_b"])))), devs)):
            full = torch.cat([tail.to(dt_), c_in], dim=1)
            new_conv.append(full[:, -(W - 1):, :].float())
            outs.append(_conv_taps(full, w, b, S, dt_))
        conv_out, new_conv = TP.join(outs, -1, x.device), tuple(new_conv)
    else:
        full = torch.cat([cache.conv.to(dt_), conv_in], dim=1)
        new_conv = full[:, -(W - 1):, :].float()
        conv_out = _conv_taps(full, params["conv_w"], params["conv_b"], S, dt_)

    xs, bmat, cmat = torch.split(conv_out, [di, ns, ns], dim=-1)
    dt_act = F.softplus(dt_raw.float() + params["dt_bias"])  # (B, S, H)
    a = -torch.exp(params["a_log"].float())  # (H,) negative decay rates
    log_a = dt_act * a[None, None, :]  # (B, S, H) log decays
    xh = xs.reshape(B, S, nh, s.head_dim)
    xh_dt = xh.float() * dt_act[..., None]  # dt-scaled input

    # the reference's chunk rule: a length that is not a multiple of the
    # chunk runs as one-token chunks
    chunk = min(s.chunk if S % min(s.chunk, S) == 0 else 1, S)
    if cache is not None and isinstance(cache.h, tuple):  # each shard its heads
        devs = [t.device for t in cache.h]
        n = len(devs)
        ys, h_new = [], []
        for h_s, (x_s, la_s, b_s, c_s) in zip(cache.h, TP.send(
                [(x_s, la_s, bmat, cmat) for x_s, la_s in zip(
                    (xh_dt.to(dt_) if S > 1 else xh_dt).chunk(n, 2), log_a.chunk(n, 2))], devs)):
            y_s, h_s = (kops.ssd_scan(x_s, la_s, b_s, c_s, chunk=chunk) if S > 1
                        else _ssd_step(h_s, x_s, la_s, b_s, c_s))
            ys.append(y_s)
            h_new.append(h_s)
        y = TP.join(ys, 2, x.device)
        new_cache = SSDCache(h=tuple(h_new), conv=new_conv, pos=cache.pos + S)
    elif cache is None or S > 1:
        # chunked SSD over the sequence; with a cache this is prefill, which
        # starts from the empty state and records the final state
        y, h_fin = kops.ssd_scan(xh_dt.to(dt_), log_a, bmat, cmat, chunk=chunk)
        new_cache = None if cache is None else SSDCache(h=h_fin, conv=new_conv,
                                                        pos=cache.pos + S)
    else:
        y, h_new = _ssd_step(cache.h, xh_dt, log_a, bmat, cmat)
        new_cache = SSDCache(h=h_new, conv=new_conv, pos=cache.pos + S)

    y = y.float() + params["d_skip"][None, None, :, None] * xh.float()
    y = y.reshape(B, S, di)
    # gated RMSNorm (Mamba-2): norm(y * silu(z))
    gated = y * F.silu(z.float())
    ms = (gated * gated).mean(-1, keepdim=True)
    y = gated * torch.rsqrt(ms + 1e-6) * params["norm_scale"]
    return row_product(y.to(dt_), params["out_proj"], like=x), new_cache
