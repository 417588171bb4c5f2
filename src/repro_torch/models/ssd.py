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
shard projects its columns, which join on the row's first device; the conv,
the scan and the gated RMSNorm (over the whole ``d_inner``, so it needs
every head's y) run there whole, on the cache's layout; y's columns then go
out to the shards for their rows of ``out_proj``, and the parts add in shard
order.  With x in sequence slices (``tp.SeqSlices``, the reference's
sequence parallelism) the slices are gathered whole onto each shard for
``in_proj`` and the parts of ``out_proj`` reduce-scattered back into
slices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops as kops
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
    h: torch.Tensor  # (B, H, N, P) recurrent state, float32
    conv: torch.Tensor  # (B, W-1, conv_dim) conv tail, float32
    pos: torch.Tensor  # scalar int32

    def tensors(self):
        return (self.h, self.conv, self.pos)


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

    if cache is None or S > 1:
        # chunked SSD over the sequence; with a cache this is prefill, which
        # starts from the empty state and records the final state.  The
        # reference's chunk rule: a length that is not a multiple of the
        # chunk runs as one-token chunks.
        chunk = s.chunk if S % min(s.chunk, S) == 0 else 1
        y, h_fin = kops.ssd_scan(xh_dt.to(dt_), log_a, bmat, cmat, chunk=min(chunk, S))
        new_cache = None if cache is None else SSDCache(h=h_fin, conv=new_conv,
                                                        pos=cache.pos + S)
    else:
        # single-step recurrence
        a_step = torch.exp(log_a[:, 0])  # (B, H)
        outer = torch.einsum("bn,bhp->bhnp", bmat[:, 0].float(), xh_dt[:, 0])
        h_new = a_step[..., None, None] * cache.h + outer
        y = torch.einsum("bn,bhnp->bhp", cmat[:, 0].float(), h_new)
        y = y[:, None].reshape(B, 1, nh, s.head_dim)
        new_cache = SSDCache(h=h_new, conv=new_conv, pos=cache.pos + S)

    y = y.float() + params["d_skip"][None, None, :, None] * xh.float()
    y = y.reshape(B, S, di)
    # gated RMSNorm (Mamba-2): norm(y * silu(z))
    gated = y * F.silu(z.float())
    ms = (gated * gated).mean(-1, keepdim=True)
    y = gated * torch.rsqrt(ms + 1e-6) * params["norm_scale"]
    return row_product(y.to(dt_), params["out_proj"], like=x), new_cache
